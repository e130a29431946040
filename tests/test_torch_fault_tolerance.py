"""The port's fault tolerance (runtime/errors.py, runtime/health.py, the
coordinator's retries, deadlines and quarantine, runtime/chaos.py) against
the reference's, on the CPU: the counterpart of tests/test_fault_tolerance.py.

Every case runs both packages on the same input (the reference suites'
hand-built sum-by-key plan, or TPC-H at SF 0.002, seed 7) and compares what
each observes:

- the error classes and whether each is retryable; each class's wire dict,
  decoded by the other package into the same class;
- the circuit breaker's state sequence and its single half-open probe,
  driven by an injected clock;
- under the same seeded chaos schedules: the multiset of ``plan.fired``
  (without the task number where a fault hits whichever task of a stage
  calls first) and ``FaultCounters.as_dict()`` (quarantines and reroutes,
  which follow how tasks interleave, where one worker alone fails), and
  the result with its capacity;
- fail-fast on a fatal error, a corrupt plan becoming the same classified
  DFTPU043 error, ``max_task_retries = 0`` and the class of the last error
  once retries run out;
- the slow-worker timeout with reroute, the first-chunk deadline of the
  streaming plane and the worker-level execute deadline;
- quarantine, and the query that fails once no healthy worker is left;
- slices released after a failed dispatch; ``FAULT_TOLERANCE_DEFAULTS``;
- single-fault TPC-H parity (q1, q3, q12);
- over localhost gRPC (the port's workers on ``device="cpu"``): an
  unreachable worker and a dead worker rerouted to its live peer.
"""

import os
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_port_helpers import (
    BOTH,
    PORT,
    REF,
    assert_matches_reference,
    assert_no_leaks,
    identical,
    sum_by_key_plan,
    tpch_contexts,
)

torch.set_num_threads(1)

CHAOS_SEED = int(os.environ.get("DFTPU_CHAOS_SEED", "20260803"))
FAST = {"task_retry_backoff_s": 0.001, "quarantine_seconds": 0.05}
WIRE_CLASSES = ("WorkerError", "TransportError", "WorkerUnavailableError",
                "TaskTimeoutError", "PlanIntegrityError")
ERROR_CLASSES = WIRE_CLASSES + ("PlanningError",)


def _coord(P, cluster, adaptive=False, **opts):
    rt = P("runtime.coordinator")
    cls = rt.AdaptiveCoordinator if adaptive else rt.Coordinator
    return cls(resolver=cluster, channels=cluster,
               config_options={**FAST, **opts})


def _cluster(P, n):
    return P("runtime.coordinator").InMemoryCluster(n)


def _chaos(P, cluster, specs, seed=CHAOS_SEED):
    """``cluster`` wrapped in a FaultPlan of ``specs`` (FaultSpec kwargs)."""
    chaos = P("runtime.chaos")
    plan = chaos.FaultPlan(seed, [chaos.FaultSpec(**s) for s in specs])
    return chaos.wrap_cluster(cluster, plan), plan


def _fired(plan) -> list:
    return sorted((f["site"], f["stage_id"], f["task_number"], f["kind"],
                   f["nth_call"]) for f in plan.fired)


def _fired_per_stage(plan) -> list:
    """``one_crash_per_stage`` crashes the first task of each stage to call
    execute, which is a race between the stage's tasks in both packages:
    its firings are compared without the task number."""
    return sorted((f["site"], f["stage_id"], f["kind"], f["nth_call"])
                  for f in plan.fired)


#: counters that follow how the tasks of a stage interleave on the workers
#: (a worker's consecutive failures trip its breaker, and a tripped worker
#: changes where the next retry goes), in both packages alike
INTERLEAVED = ("workers_quarantined", "tasks_rerouted")


def _faults(coord, interleaved: bool = False) -> dict:
    return {k: v for k, v in coord.faults.as_dict().items()
            if v and (interleaved or k not in INTERLEAVED)}


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


def test_error_classes_and_retryability():
    got = {}
    for P in BOTH:
        e = P("runtime.errors")
        got[P] = [(n, e.is_retryable(getattr(e, n)("x")),
                   issubclass(getattr(e, n), e.WorkerError))
                  for n in ERROR_CLASSES]
        got[P].append(("ValueError", e.is_retryable(ValueError("x")), False))
    assert got[PORT] == got[REF]


@pytest.mark.parametrize("cls", WIRE_CLASSES)
def test_error_class_crosses_the_wire_both_ways(cls):
    dicts = {}
    for P in BOTH:
        e = P("runtime.errors")
        err = getattr(e, cls)("msg", worker_url="mem://w0",
                              task=P("runtime.worker").TaskKey("q", 2, 1))
        dicts[P] = err.to_dict()
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k != "original_traceback"}
    assert strip(dicts[PORT]) == strip(dicts[REF])
    for src, dst in ((PORT, REF), (REF, PORT)):
        e = dst("runtime.errors")
        back = e.WorkerError.from_dict(dicts[src])
        assert type(back).__name__ == cls
        assert e.is_retryable(back) == REF("runtime.errors").is_retryable(
            getattr(REF("runtime.errors"), cls)("x"))
        assert back.worker_url == "mem://w0"
        assert (back.task.query_id, back.task.stage_id,
                back.task.task_number) == ("q", 2, 1)
    for P in BOTH:
        d = dict(dicts[P], error_class="SomeFutureError")
        assert type(P("runtime.errors").WorkerError.from_dict(d)).__name__ \
            == "WorkerError"


def test_wrap_preserves_retryable_class():
    got = {}
    for P in BOTH:
        e = P("runtime.errors")
        key = P("runtime.worker").TaskKey("q", 0, 0)
        t = e.TransportError("link reset")
        w1 = e.wrap_worker_exception(t, "mem://w1", key)
        w2 = e.wrap_worker_exception(ValueError("bad data"), "mem://w1",
                                     None)
        got[P] = (w1 is t, w1.worker_url, type(w2).__name__,
                  e.is_retryable(w2), w2.original_type, str(w2))
    assert got[PORT] == got[REF]


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def _breaker_sequence(P) -> list:
    h = P("runtime.health")
    clock = [0.0]
    t = h.HealthTracker(h.HealthPolicy(failure_threshold=2,
                                       quarantine_seconds=10.0,
                                       backoff_factor=2.0),
                        clock=lambda: clock[0])
    u = "mem://w0"
    seq = []

    def note(what, value):
        snap = t.snapshot().get(u, {})
        seq.append((what, value, t.state_of(u),
                    {k: snap.get(k) for k in ("trips", "open_for_s",
                                              "consecutive_failures")}))

    note("available", t.is_available(u))
    note("failure", t.record_failure(u))
    note("available", t.is_available(u))
    note("failure", t.record_failure(u))
    note("available", t.is_available(u))
    clock[0] = 10.5
    note("available", t.is_available(u))
    note("failure", t.record_failure(u))
    clock[0] = 40.0
    note("available", t.is_available(u))
    note("success", t.record_success(u))
    note("available", t.is_available(u))
    return seq


def _half_open_sequence(P) -> list:
    h = P("runtime.health")
    clock = [0.0]
    t = h.HealthTracker(h.HealthPolicy(failure_threshold=1,
                                       quarantine_seconds=10.0),
                        clock=lambda: clock[0])
    u = "mem://w0"
    seq = [t.record_failure(u)]
    for now in (10.1, 10.1, 10.1, 20.2, 20.2):
        clock[0] = now
        seq.append((now, t.is_available(u), t.state_of(u)))
    t.record_success(u)
    seq.append((t.is_available(u), t.is_available(u), t.state_of(u)))
    return seq


def test_circuit_breaker_open_halfopen_recovery():
    seq = _breaker_sequence(PORT)
    assert seq == _breaker_sequence(REF)
    h = PORT("runtime.health")
    states = [s[2] for s in seq]
    assert h.OPEN in states and h.HALF_OPEN in states
    assert states[-1] == h.CLOSED


def test_half_open_admits_a_single_probe():
    seq = _half_open_sequence(PORT)
    assert seq == _half_open_sequence(REF)
    # one probe per cool-down: admitted, refused, refused; re-admitted once
    assert [s[1] for s in seq[1:6]] == [True, False, False, True, False]


# ---------------------------------------------------------------------------
# retry and reroute under seeded schedules
# ---------------------------------------------------------------------------


def _chaos_run(P, specs, workers=2, plans=1, seed=CHAOS_SEED, **opts):
    """The sum-by-key plan ``plans`` times over a chaos-wrapped cluster ->
    (the last result, fired, counters)."""
    cluster = _cluster(P, workers)
    wrapped, plan = _chaos(P, cluster, specs, seed)
    coord = _coord(P, wrapped, **opts)
    for _ in range(plans):
        out = coord.execute(sum_by_key_plan(P))
    assert_no_leaks(cluster)
    return out, _fired(plan), _faults(coord)


def _one_crash_per_stage(P, **opts):
    cluster = _cluster(P, 3)
    chaos = P("runtime.chaos")
    wrapped = chaos.wrap_cluster(cluster,
                                 chaos.one_crash_per_stage(CHAOS_SEED))
    coord = _coord(P, wrapped, **opts)
    out = coord.execute(sum_by_key_plan(P))
    assert_no_leaks(cluster)
    return out, _fired_per_stage(wrapped.plan), _faults(coord)


@pytest.mark.parametrize("opts", [{}, {"peer_shuffle": False}],
                         ids=["peer", "partition_stream"])
def test_single_crash_per_stage(opts):
    got = {P: _one_crash_per_stage(P, **opts) for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0])
    assert got[PORT][1:] == got[REF][1:]
    base = _coord(PORT, _cluster(PORT, 3), **opts).execute(
        sum_by_key_plan(PORT))
    assert identical(base.to_numpy(), got[PORT][0].to_numpy())
    assert got[PORT][1] and got[PORT][2].get("task_retries", 0) >= 1


def test_adaptive_bulk_plane_retries():
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 3)
        chaos = P("runtime.chaos")
        wrapped = chaos.wrap_cluster(cluster,
                                     chaos.one_crash_per_stage(CHAOS_SEED))
        coord = _coord(P, wrapped, adaptive=True)
        out = coord.execute(sum_by_key_plan(P))
        assert_no_leaks(cluster)
        got[P] = (out.to_pandas().sort_values("k").reset_index(drop=True),
                  _fired_per_stage(wrapped.plan),
                  coord.faults.get("task_retries"))
    np.testing.assert_array_equal(got[PORT][0]["k"], got[REF][0]["k"])
    np.testing.assert_allclose(got[PORT][0]["sv"], got[REF][0]["sv"],
                               rtol=1e-5)
    assert got[PORT][1] == got[REF][1]
    assert got[PORT][2] >= 1 and got[REF][2] >= 1


SCHEDULES = {
    "transient_transport": ([
        {"site": "execute", "kind": "transport", "rate": 0.5},
        {"site": "set_plan", "kind": "transport", "rate": 0.25},
    ], {"max_task_retries": 6}, 1, CHAOS_SEED),
    "no_leak_three_queries": ([
        {"site": "execute", "kind": "crash", "rate": 0.3},
        {"site": "set_plan", "kind": "transport", "rate": 0.2},
    ], {"max_task_retries": 8}, 3, CHAOS_SEED + 1),
    "smoke_deterministic": ([
        {"site": "execute", "kind": "transport", "rate": 0.4},
    ], {"max_task_retries": 8}, 1, CHAOS_SEED),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_seeded_schedule_fires_alike(name):
    specs, opts, plans, seed = SCHEDULES[name]
    workers = 3 if name == "no_leak_three_queries" else 2
    got = {P: _chaos_run(P, specs, workers, plans, seed, **opts)
           for P in BOTH}
    assert_matches_reference(got[REF][0], got[PORT][0], name)
    assert got[PORT][1] == got[REF][1] and got[PORT][1], name
    assert got[PORT][2] == got[REF][2], name
    if name == "smoke_deterministic":
        again = _chaos_run(PORT, specs, workers, plans, seed, **opts)
        assert identical(again[0].to_numpy(), got[PORT][0].to_numpy())
        assert again[1] == got[PORT][1]


def _failure(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the observed failure
        return e
    raise AssertionError("no failure")


def test_fatal_error_fails_fast_no_retries():
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 2)
        calls = [0]

        def poison(plan, key, calls=calls):
            calls[0] += 1
            raise ValueError("query-semantic failure (bad expression)")

        for w in cluster.workers.values():
            w.on_plan = poison
        coord = _coord(P, cluster)
        e = _failure(lambda: coord.execute(sum_by_key_plan(P)))
        assert_no_leaks(cluster)
        got[P] = (type(e).__name__, P("runtime.errors").is_retryable(e),
                  e.original_type, calls[0], _faults(coord))
    assert got[PORT] == got[REF]
    assert got[PORT][1:4] == (False, "ValueError", 1)
    assert got[PORT][4].get("fatal_failures") == 1
    assert "task_retries" not in got[PORT][4]


@pytest.mark.parametrize("verify", ["strict", "off"])
def test_corrupt_plan(verify):
    specs = [{"site": "set_plan", "kind": "corrupt_plan", "rate": 1.0,
              "max_total": 1}]
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 2)
        wrapped, plan = _chaos(P, cluster, specs)
        opts = {} if verify == "strict" else {"verify_plans": "off"}
        coord = _coord(P, wrapped, **opts)
        if verify == "off":
            out = coord.execute(sum_by_key_plan(P))
            got[P] = (out, _fired_per_stage(plan))
            continue
        e = _failure(lambda: coord.execute(sum_by_key_plan(P)))
        errors = P("runtime.errors")
        back = errors.WorkerError.from_dict(e.to_dict())
        assert_no_leaks(cluster)
        got[P] = (type(e).__name__, "DFTPU043" in str(e),
                  errors.is_retryable(e), type(back).__name__,
                  _fired_per_stage(plan), _faults(coord))
    if verify == "off":
        # the corrupted capacity runs unchecked: both packages run it alike
        assert_matches_reference(got[REF][0], got[PORT][0])
        assert got[PORT][1] == got[REF][1]
        assert [f[2] for f in got[PORT][1]] == ["corrupt_plan"]
        return
    assert got[PORT] == got[REF]
    assert got[PORT][:4] == ("PlanIntegrityError", True, False,
                             "PlanIntegrityError")
    assert got[PORT][5].get("fatal_failures") == 1
    assert "task_retries" not in got[PORT][5]


@pytest.mark.parametrize("retries", [0, 2])
def test_retries_run_out(retries):
    rate = {"rate": 1.0, "max_total": 1} if retries == 0 else {"rate": 1.0}
    specs = [{"site": "execute", "kind": "crash", **rate}]
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 2)
        wrapped, plan = _chaos(P, cluster, specs)
        coord = _coord(P, wrapped, max_task_retries=retries)
        e = _failure(lambda: coord.execute(sum_by_key_plan(P)))
        assert_no_leaks(cluster)
        got[P] = (type(e).__name__, _fired_per_stage(plan), _faults(coord))
    assert got[PORT][0] == got[REF][0] == "WorkerUnavailableError"
    assert got[PORT][2].get("retries_exhausted", 0) >= 1
    if retries == 0:
        assert got[PORT] == got[REF]
        assert "task_retries" not in got[PORT][2]
    else:
        # sibling tasks stop at the first exhausted one's cancel, so how
        # many crashes fire is timing; the counters' keys are not
        assert sorted(got[PORT][2]) == sorted(got[REF][2])


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

#: an injected hang of HANG_S against a deadline of DEADLINE_S
HANG_S, DEADLINE_S = 5.0, 2.0


@pytest.mark.parametrize("plane", ["root_bulk", "first_chunk"])
def test_deadline_converts_hang_and_reroutes(plane):
    stages, opts = (([-1], {}) if plane == "root_bulk"
                    else ([1], {"peer_shuffle": False}))
    specs = [{"site": "execute", "kind": "delay", "delay_s": HANG_S,
              "rate": 1.0, "stages": stages, "max_total": 1}]
    got = {}
    for P in BOTH:
        # warm: the deadline must bite the injected hang, not a compile
        base = _coord(P, _cluster(P, 2), **opts).execute(sum_by_key_plan(P))
        cluster = _cluster(P, 2)
        wrapped, plan = _chaos(P, cluster, specs)
        coord = _coord(P, wrapped, task_timeout_s=DEADLINE_S, **opts)
        t0 = time.monotonic()
        out = coord.execute(sum_by_key_plan(P))
        elapsed = time.monotonic() - t0
        assert identical(base.to_numpy(), out.to_numpy()), P
        assert elapsed < HANG_S + 10.0, (P, elapsed)
        got[P] = (out, _fired_per_stage(plan),
                  coord.faults.get("task_timeouts"))
        if plane == "first_chunk":
            assert_no_leaks(cluster)
    assert_matches_reference(got[REF][0], got[PORT][0], plane)
    assert got[PORT][1] == got[REF][1]
    assert got[PORT][2] >= 1 and got[REF][2] >= 1


def test_worker_level_execute_deadline():
    got = {}
    for P in BOTH:
        w = P("runtime.worker").Worker("mem://slow")
        orig = w._execute_task_body
        w._execute_task_body = lambda key, orig=orig: (time.sleep(0.5),
                                                       orig(key))[1]
        e = _failure(lambda: w.execute_task(
            P("runtime.worker").TaskKey("q", 0, 0), timeout=0.05))
        got[P] = (type(e).__name__, P("runtime.errors").is_retryable(e),
                  e.worker_url)
    assert got[PORT] == got[REF] == ("TaskTimeoutError", True, "mem://slow")


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------


def test_flaky_worker_quarantined_and_routed_around():
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 2)
        bad = cluster.get_urls()[0]
        wrapped, plan = _chaos(P, cluster, [
            {"site": "execute", "kind": "crash", "rate": 1.0,
             "workers": [bad]},
            {"site": "set_plan", "kind": "crash", "rate": 1.0,
             "workers": [bad]}])
        coord = _coord(P, wrapped, quarantine_threshold=1,
                       quarantine_seconds=3600.0, max_task_retries=4)
        first = coord.execute(sum_by_key_plan(P))
        fired_first = _fired_per_stage(plan)
        state = coord.health.state_of(bad)
        second = coord.execute(sum_by_key_plan(P))
        assert_no_leaks(cluster)
        got[P] = (first, second, fired_first, len(plan.fired), state,
                  _faults(coord, interleaved=True))
    assert_matches_reference(got[REF][0], got[PORT][0])
    assert_matches_reference(got[REF][1], got[PORT][1])
    assert got[PORT][2:] == got[REF][2:]
    assert got[PORT][4] == PORT("runtime.health").OPEN
    # the second query never consulted the quarantined worker
    assert got[PORT][3] == len(got[PORT][2])
    assert got[PORT][5].get("workers_quarantined", 0) >= 1


def test_query_fails_only_when_no_healthy_worker_remains():
    specs = [{"site": "execute", "kind": "crash", "rate": 1.0},
             {"site": "set_plan", "kind": "crash", "rate": 1.0}]
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 2)
        wrapped, _plan = _chaos(P, cluster, specs)
        coord = _coord(P, wrapped, quarantine_threshold=1,
                       quarantine_seconds=3600.0, max_task_retries=8)
        e = _failure(lambda: coord.execute(sum_by_key_plan(P)))
        assert_no_leaks(cluster)
        opened = sum(1 for s in coord.health.snapshot().values()
                     if s["state"] == P("runtime.health").OPEN)
        got[P] = (type(e).__name__, opened)
    assert got[PORT] == got[REF]
    assert got[PORT][0] == "WorkerUnavailableError" and got[PORT][1] >= 1


# ---------------------------------------------------------------------------
# cleanup, defaults, observability
# ---------------------------------------------------------------------------


def test_dispatch_failure_releases_staged_slices():
    got = {}
    for P in BOTH:
        cluster = _cluster(P, 1)
        w = next(iter(cluster.workers.values()))

        def failing_set_plan(*a, **kw):
            raise RuntimeError("ship exploded")

        w.set_plan = failing_set_plan
        coord = P("runtime.coordinator").Coordinator(resolver=cluster,
                                                     channels=cluster)
        rng = np.random.default_rng(0)
        t = P.table(pa.table({"x": rng.integers(0, 9, 64)}))
        stage_plan = P("plan.physical").MemoryScanExec([t], t.schema())
        e = _failure(lambda: coord._dispatch_task(stage_plan, "q", 0, 0, 1))
        got[P] = (type(e).__name__, str(e), dict(w.table_store.tables))
    assert got[PORT] == got[REF] == ("RuntimeError", "ship exploded", {})


def test_fault_tolerance_defaults_equal():
    got = {}
    for P in BOTH:
        rt = P("runtime.coordinator")
        c = rt.Coordinator(resolver=None, channels=None)
        got[P] = (dict(rt.FAULT_TOLERANCE_DEFAULTS),
                  [c._opt_int("max_task_retries"),
                   c._opt_float("task_retry_backoff_s"),
                   c._opt_float("task_timeout_s"),
                   c._opt_float("dispatch_timeout_s"),
                   c._opt_int("quarantine_threshold"),
                   c._opt_float("quarantine_seconds")])
    assert got[PORT] == got[REF]
    assert got[PORT][1] == [2, 0.05, 0.0, 0.0, 3, 30.0]


def test_fault_counters_surface_in_observability():
    got = {}
    for P in BOTH:
        out, _fired_, faults = _one_crash_per_stage(P)
        cluster = _cluster(P, 2)
        chaos = P("runtime.chaos")
        wrapped = chaos.wrap_cluster(cluster,
                                     chaos.one_crash_per_stage(CHAOS_SEED))
        coord = _coord(P, wrapped)
        coord.execute(sum_by_key_plan(P))
        obs = P("runtime.observability").ObservabilityService(
            cluster, cluster, health=coord.health,
            fault_counters=coord.faults)
        got[P] = ({k: v for k, v in obs.get_fault_counters().items() if v},
                  sorted(obs.get_worker_health()),
                  len(obs.get_cluster_workers()))
    assert got[PORT] == got[REF]
    assert got[PORT][0].get("task_retries", 0) >= 1 and got[PORT][2] == 2


# ---------------------------------------------------------------------------
# gRPC
# ---------------------------------------------------------------------------


def test_grpc_unreachable_worker_maps_to_unavailable():
    pytest.importorskip("grpc")
    got = {}
    for P in BOTH:
        mod = P("runtime.grpc_worker")
        kw = {"device": "cpu"} if P is PORT else {}
        client = mod.GrpcWorkerClient("grpc://127.0.0.1:1", **kw)
        e = _failure(client.get_info)
        got[P] = (type(e).__name__, P("runtime.errors").is_retryable(e),
                  e.worker_url)
    assert got[PORT] == got[REF] == ("WorkerUnavailableError", True,
                                     "grpc://127.0.0.1:1")


def test_grpc_dead_worker_reroutes_to_live_peer():
    pytest.importorskip("grpc")
    got = {}
    for P in BOTH:
        kw = {"device": "cpu"} if P is PORT else {}
        cluster = P("runtime.grpc_worker").GrpcCluster(2, **kw)
        try:
            cluster.servers[0].stop(grace=None)
            coord = _coord(P, cluster, max_task_retries=6)
            out = coord.execute(sum_by_key_plan(P))
            got[P] = (out, coord.faults.get("task_retries"))
        finally:
            cluster.shutdown()
    assert_matches_reference(got[REF][0], got[PORT][0])
    base = _coord(PORT, _cluster(PORT, 1)).execute(sum_by_key_plan(PORT))
    assert identical(base.to_numpy(), got[PORT][0].to_numpy())
    assert got[PORT][1] >= 1 and got[REF][1] >= 1


# ---------------------------------------------------------------------------
# TPC-H under one crash a stage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    return tpch_contexts(bytes_per_task=1)


@pytest.mark.parametrize("qname", ["q1", "q12", "q3"])
def test_tpch_single_fault_parity(tpch, qname):
    from tests.test_fault_tolerance import TPCH_QUERIES

    sql = TPCH_QUERIES[qname]
    got = {}
    for P in BOTH:
        rt, chaos = P("runtime.coordinator"), P("runtime.chaos")
        df = tpch[P].sql(sql)
        base = df.collect_coordinated_table(
            coordinator=_coord(P, rt.InMemoryCluster(3)), num_tasks=4)
        cluster = rt.InMemoryCluster(3)
        wrapped = chaos.wrap_cluster(cluster,
                                     chaos.one_crash_per_stage(CHAOS_SEED))
        coord = _coord(P, wrapped)
        out = df.collect_coordinated_table(coordinator=coord, num_tasks=4)
        assert identical(base.to_numpy(), out.to_numpy()), P
        assert_no_leaks(cluster)
        got[P] = (out, _fired_per_stage(wrapped.plan), _faults(coord))
    assert_matches_reference(got[REF][0], got[PORT][0], qname)
    assert got[PORT][1:] == got[REF][1:]
    assert got[PORT][1] and got[PORT][2].get("task_retries", 0) >= 1
