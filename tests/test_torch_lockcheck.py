"""The port's lock-order harness (runtime/lockcheck.py) against the
reference's, and the repo's lint tools run over the port's files.

Counterparts of tests/test_concurrency_check.py's dynamic half: every
in-process case drives the same scenario through both packages' harnesses
(``wrap_lock``, no factories installed) and compares what they report. The
install cases arm one package per subprocess: each harness keeps the
threading factories it found at its import, so a second install in one
process would wrap the first one's factory.

The lint half runs tools/check_concurrency.py and
tools/check_resource_lifecycle.py over every file of the port with
``--allowlist`` pointing at the port's own lists
(datafusion_distributed_tpu_torch/lint/). Given files, the tools skip
their stale-entry check, so the tests assert that every entry still
matches a finding. Of tools/check_tracer_safety.py only the determinism
rules (unordered iteration, mutable defaults) reach the port: its trace
paths are the reference package's directories."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from datafusion_distributed_tpu.runtime import lockcheck as jlock
from datafusion_distributed_tpu_torch.runtime import lockcheck as tlock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "datafusion_distributed_tpu_torch")
LINT = os.path.join(PORT, "lint")
BOTH = (("reference", jlock), ("port", tlock))


@pytest.fixture(autouse=True)
def _fresh():
    for _, m in BOTH:
        m.reset()
    yield
    for _, m in BOTH:
        m.reset()


def _inversion(lc):
    """Thread 1 takes A then B, thread 2 B then A: -> the violation text."""
    a = lc.wrap_lock(name="Inv._a")
    b = lc.wrap_lock(name="Inv._b")
    errors = []

    def forward():
        with a:
            time.sleep(0.05)
            with b:
                pass

    def backward():
        time.sleep(0.02)
        try:
            with b:
                time.sleep(0.05)
                with a:
                    pass
        except lc.LockOrderViolation as e:
            errors.append(str(e))

    t1 = threading.Thread(target=forward)
    t2 = threading.Thread(target=backward)
    t1.start()
    t2.start()
    t1.join(timeout=10)
    t2.join(timeout=10)
    return errors


def test_lock_inversion_reports_cycle_with_both_stacks():
    out = {}
    for name, lc in BOTH:
        errors = _inversion(lc)
        assert errors, f"{name}: inversion not detected"
        msg = errors[0]
        assert "Inv._a" in msg and "Inv._b" in msg
        assert "this acquisition" in msg and "prior acquisition" in msg
        out[name] = msg.splitlines()[0]
    # both stacks name this test file (real tracebacks): the port drops
    # only its own frames, where the reference drops every file whose name
    # ends in lockcheck.py, this one's too
    assert errors[0].count(os.path.basename(__file__)) >= 2
    assert out["port"] == out["reference"]


def test_recurring_inversion_keeps_raising():
    raised = {}
    for name, lc in BOTH:
        a = lc.wrap_lock(name="Rec._a")
        b = lc.wrap_lock(name="Rec._b")
        with a:
            with b:
                pass
        n = 0
        for _ in range(3):
            with b:
                with pytest.raises(lc.LockOrderViolation):
                    a.acquire()
                n += 1
        raised[name] = (n, lc.report(include_static=False)["observed_edges"])
    assert raised["port"] == raised["reference"]
    assert raised["port"][0] == 3


def test_same_lock_reentry_raises_instead_of_hanging():
    for _, lc in BOTH:
        c = lc.wrap_lock(name="Re._c", kind="lock")
        with c:
            with pytest.raises(lc.LockReentryError, match="Re._c"):
                c.acquire()
        assert not c.locked()


def test_rlock_reentry_is_fine():
    reports = {}
    for name, lc in BOTH:
        r = lc.wrap_lock(name="Re._r", kind="rlock")
        with r:
            with r:
                pass
        reports[name] = lc.report(include_static=False)
    assert reports["port"]["observed_edges"] == []
    assert reports["port"] == reports["reference"]


def test_observed_edge_merges_against_static_graph():
    """An observed nesting the static analyzer predicted over the
    harness's own package is `static`; an order it never saw is `new`."""
    statuses = {}
    for name, lc in BOTH:
        sess = lc.wrap_lock(name="ServingSession._lock")
        sched = lc.wrap_lock(name="GlobalStageScheduler._lock")
        novel = lc.wrap_lock(name="NoSuchClass._lock")
        with sess:
            with sched:
                pass
        with sched:
            with novel:
                pass
        rep = lc.report(include_static=True)
        assert rep["static_edges"], f"{name}: static graph failed to load"
        statuses[name] = {(e["src"], e["dst"]): e["status"]
                          for e in rep["observed_edges"]}
    assert statuses["port"] == statuses["reference"]
    assert statuses["port"][("ServingSession._lock",
                             "GlobalStageScheduler._lock")] == "static"
    assert statuses["port"][("GlobalStageScheduler._lock",
                             "NoSuchClass._lock")] == "new"


def test_static_graph_is_the_ports_own():
    """The port's static graph comes from the port's files: every node is
    a lock the port names, none a path of the reference package."""
    edges = tlock._static_edges()
    assert edges, "static graph failed to load"
    nodes = {n for e in edges for n in e}
    assert not any(n.startswith("datafusion_distributed_tpu/")
                   for n in nodes), nodes
    assert ("Worker._abandoned_lock", "TableStore._lock") in edges
    assert all(f.startswith(PORT) for f in tlock._package_files())


def test_hold_time_outlier_recorded():
    held = {}
    for name, lc in BOTH:
        slow = lc.wrap_lock(name="Slow._lock")
        with slow:
            time.sleep(lc._HOLD_OUTLIER_S + 0.05)
        held[name] = [o["lock"] for o in
                      lc.report(include_static=False)["hold_outliers"]]
    assert held["port"] == held["reference"] == ["Slow._lock"]


def test_note_blocking_records_lock_while_building(monkeypatch):
    """The reference notes its XLA compile entry; the port notes the
    first-use build of a kernel library (ops/_build.py, native/)."""
    events = {}
    for name, lc, what in (("reference", jlock, "xla_compile"),
                           ("port", tlock, "kernel_build")):
        monkeypatch.setattr(lc, "_installed", True)
        held = lc.wrap_lock(name="Compiler._lock")
        lc.note_blocking(what)  # nothing held: nothing recorded
        with held:
            lc.note_blocking(what)
        events[name] = [(e["kind"], e["locks_held"]) for e in
                        lc.report(include_static=False)["events"]]
    assert events["reference"] == [("lock_while_xla_compile",
                                    ["Compiler._lock"])]
    assert events["port"] == [("lock_while_kernel_build",
                               ["Compiler._lock"])]


def test_kernel_build_entries_note_blocking(monkeypatch):
    """ops/_build.py and native/ call note_blocking before a first-use
    build, and not once the library is loaded."""
    from datafusion_distributed_tpu_torch import native
    from datafusion_distributed_tpu_torch.ops import _build

    seen = []
    monkeypatch.setattr(tlock, "note_blocking", seen.append)
    monkeypatch.setattr(_build, "_LIBS", {"x.cu": object()})
    _build.load("x.cu")
    assert seen == []
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda src: (_ for _ in ()).throw(
        RuntimeError("no nvcc here")))
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.load("x.cu")
    assert seen == ["kernel_build"]
    seen.clear()
    monkeypatch.setattr(native, "_lib", None)
    native.load()  # g++ at first use, or the built library
    assert seen == ["kernel_build"]
    seen.clear()
    native.load()
    assert seen == []


_INSTALL = textwrap.dedent("""
    import sys, threading, time
    PKG = sys.argv[1]
    if PKG == "datafusion_distributed_tpu_torch":
        sys.modules["jax"] = None
    import importlib
    importlib.import_module(PKG)  # installs the harness
    lockcheck = importlib.import_module(PKG + ".runtime.lockcheck")
    assert lockcheck.enabled()
    metrics = importlib.import_module(PKG + ".runtime.metrics")
    ms, fc = metrics.MetricsStore(), metrics.FaultCounters()
    names = [ms._lock.name, fc._lock.name]
    foreign = threading.Lock()  # created here, outside the package
    assert not hasattr(foreign, "name"), foreign

    def forward():
        with ms._lock:
            time.sleep(0.05)
            with fc._lock:
                pass

    hit = []
    def backward():
        time.sleep(0.02)
        try:
            with fc._lock:
                time.sleep(0.05)
                with ms._lock:
                    pass
        except lockcheck.LockOrderViolation as e:
            hit.append(str(e).splitlines()[0])

    t1 = threading.Thread(target=forward)
    t2 = threading.Thread(target=backward)
    t1.start(); t2.start()
    t1.join(10); t2.join(10)
    assert hit, "inversion not detected under the installed harness"
    print("INSTALL " + repr((names, hit)))
""")


def _install_run(pkg: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", DFTPU_LOCK_CHECK="1",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _INSTALL, pkg],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return [ln for ln in r.stdout.splitlines() if ln.startswith("INSTALL ")][0]


def test_install_at_package_init_names_package_locks():
    """DFTPU_LOCK_CHECK=1 at import wraps the port's own locks under their
    static-graph names and reports an inversion between them as the
    reference's harness does in its own process."""
    port = _install_run("datafusion_distributed_tpu_torch")
    ref = _install_run("datafusion_distributed_tpu")
    assert port == ref
    assert "MetricsStore._lock" in port and "FaultCounters._lock" in port


_SERVED = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    import datafusion_distributed_tpu_torch  # installs the harness
    from datafusion_distributed_tpu_torch.data import tpchgen
    from datafusion_distributed_tpu_torch.runtime import lockcheck
    from datafusion_distributed_tpu_torch.runtime.grpc_worker import (
        start_localhost_cluster,
    )
    from datafusion_distributed_tpu_torch.runtime.serving import (
        ServingSession,
    )
    from datafusion_distributed_tpu_torch.sql.context import SessionContext
    ctx = SessionContext(device="cpu")
    tpchgen.register_tpch(ctx, 0.001, 7)
    qs = [open(f"benchmarks/queries/tpch/{q}.sql").read()
          for q in ("q1", "q6")]
    want = [ctx.sql(q).collect_table().to_numpy() for q in qs]
    cluster = start_localhost_cluster(2, device="cpu", rpc_timeout_s=120)
    try:
        with ServingSession(ctx, cluster=cluster, num_tasks=2) as srv:
            hs = [srv.submit(qs[i % 2]) for i in range(4)]
            got = [h.result_table(timeout=120).to_numpy() for h in hs]
    finally:
        cluster.shutdown()
    for i, g in enumerate(got):
        w = want[i % 2]
        assert list(g) == list(w) and all(len(g[k]) == len(w[k]) for k in w)
    rep = lockcheck.report()
    print("REPORT " + json.dumps({
        "edges": [[e["src"], e["dst"], e["status"]]
                  for e in rep["observed_edges"]],
        "events": [e["kind"] for e in rep["events"]],
    }))
""")


def test_served_mix_over_grpc_under_the_harness():
    """The served q1/q6 mix over two localhost gRPC workers with every
    port lock instrumented: no lock-order cycle, and every observed
    edge joins the static graph's nodes or is reported as new."""
    env = dict(os.environ, DFTPU_LOCK_CHECK="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SERVED], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REPORT ")]
    rep = json.loads(line[0][len("REPORT "):])
    assert rep["edges"], rep
    assert all(s in ("static", "new") for _, _, s in rep["edges"]), rep


# ---------------------------------------------------------------------------
# the repo's lint tools over the port's files
# ---------------------------------------------------------------------------


def _port_files() -> list:
    return [os.path.relpath(f, REPO) for f in tlock._package_files()]


def _lint(tool: str, allowlist: str) -> dict:
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", tool), "--json",
         "--allowlist", allowlist, *_port_files()],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode in (0, 1), r.stderr
    return json.loads(r.stdout) | {"rc": r.returncode}


def _entries(path: str) -> set:
    out = set()
    for raw in open(path, encoding="utf-8"):
        line = raw.split("#", 1)[0].strip()
        if line:
            out.add(tuple(p.strip() for p in line.split("::")))
    return out


@pytest.mark.parametrize("tool,allowlist", [
    ("check_concurrency.py", "concurrency_allowlist.txt"),
    ("check_resource_lifecycle.py", "resource_allowlist.txt"),
])
def test_lint_is_clean_on_the_port_with_its_allowlist(tool, allowlist):
    path = os.path.join(LINT, allowlist)
    out = _lint(tool, path)
    assert out["rc"] == 0 and out["violations"] == [], out["violations"]
    allowed = {(f["path"], f["rule"], f["qualname"]) for f in out["allowed"]}
    entries = _entries(path)
    # the tools skip the stale check when given files: every entry must
    # still match a finding
    assert entries == allowed, (entries - allowed, allowed - entries)
    assert all(p.startswith("datafusion_distributed_tpu_torch/")
               for p, _, _ in entries)


def test_tracer_safety_determinism_rules_are_clean_on_the_port(tmp_path):
    empty = tmp_path / "none.txt"
    empty.write_text("")
    out = _lint("check_tracer_safety.py", str(empty))
    assert out["rc"] == 0, out["violations"]
    assert out["violations"] == [] and out["allowed"] == []
