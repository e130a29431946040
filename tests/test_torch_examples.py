"""The port's examples (`datafusion_distributed_tpu_torch/examples/`) held
against the JAX package's (`examples/`) on the CPU, each at the JAX
example's own size.

The JAX package's example runs through ``runpy.run_path`` as a script
(its ``main()``), with its standard output captured, every frame it prints
recorded (``pandas.DataFrame.to_string`` is wrapped) and its module
globals read. The port's runs through its ``main(["--device", "cpu"])``,
with what its ``run()`` returned recorded (its ``frames``, ``facts`` and
``observed``). Frames: ints, strings and row order exact, floats at
test_rtol(); staged-plan texts string for string; the rest as each test
says. The two SPMD examples also run in the one start of four gloo ranks
of tests/test_torch_spmd.py (its ``spmd`` fixture, case "examples"), and
each once over two ranks it spawns itself (``--ranks 2``)."""

from __future__ import annotations

import contextlib
import importlib
import io
import runpy
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from datafusion_distributed_tpu_torch.examples import EXAMPLES
from tests.test_torch_spmd import NT, _case, spmd  # noqa: F401 (fixture)
from tests.torch_port_helpers import assert_results_equal, identical

REPO = Path(__file__).resolve().parent.parent


def _module(name: str):
    return importlib.import_module(
        f"datafusion_distributed_tpu_torch.examples.{name}")


def reference(name: str, monkeypatch) -> tuple:
    """The JAX package's example ``name`` run as a script -> (its standard
    output, the frames it printed, its module globals)."""
    frames = []
    real = pd.DataFrame.to_string

    def recorded(self, *a, **kw):
        frames.append(self.copy())
        return real(self, *a, **kw)

    monkeypatch.setattr(pd.DataFrame, "to_string", recorded)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g = runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                           run_name="__main__")
    monkeypatch.setattr(pd.DataFrame, "to_string", real)
    return out.getvalue(), frames, g


def port(name: str, monkeypatch, *argv) -> tuple:
    """The port's example ``name`` through its ``main(["--device", "cpu",
    *argv])`` -> (its standard output, what its ``run()`` returned)."""
    mod = _module(name)
    got = {}
    real = mod.run

    def recorded(*a, **kw):
        got.update(real(*a, **kw))
        return got

    monkeypatch.setattr(mod, "run", recorded)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--device", "cpu", *argv])
    return out.getvalue(), got


def frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def printed(result: dict) -> dict:
    """A port frame as the JAX package's example prints it (through
    pandas): a column with validity but no null is a plain array."""
    return frame(pd.DataFrame({
        k: v.filled() if isinstance(v, np.ma.MaskedArray)
        and not v.mask.any() else v for k, v in result.items()}))


def between(text: str, start: str, end: str) -> str:
    """The lines of ``text`` after the line ``start`` up to the line that
    starts with ``end``, joined."""
    lines = text.splitlines()
    i = lines.index(start) + 1
    j = next(k for k in range(i, len(lines)) if lines[k].startswith(end))
    return "\n".join(lines[i:j]).rstrip("\n")


def line_after(text: str, prefix: str) -> str:
    return next(x[len(prefix):] for x in text.splitlines()
                if x.startswith(prefix))


# ---------------------------------------------------------------------------
# each example against the JAX package's
# ---------------------------------------------------------------------------


def test_in_memory_cluster(monkeypatch):
    ref_out, ref_frames, _g = reference("in_memory_cluster", monkeypatch)
    out, got = port("in_memory_cluster", monkeypatch)
    facts = got["facts"]
    assert facts["plan"] == between(ref_out, "-- staged plan --", "-- result")
    assert_results_equal(frame(ref_frames[0]),
                         printed(got["frames"]["result"]), "result")
    assert facts["metrics"] == int(line_after(
        ref_out, "worker task metrics collected: "))
    assert line_after(out, "worker task metrics collected: ") == str(
        facts["metrics"])


def test_custom_execution_plan(monkeypatch):
    from datafusion_distributed_tpu.runtime import codec as jcodec
    from datafusion_distributed_tpu_torch.runtime import codec as tcodec

    try:
        ref_out, ref_frames, g = reference("custom_execution_plan",
                                           monkeypatch)
        out, got = port("custom_execution_plan", monkeypatch)
        assert g["WinsorizeExec"].codec_kind == "winsorize"
        assert "winsorize" in jcodec._USER_CODECS
        assert got["facts"]["plan"] == between(
            ref_out, "-- staged plan (custom node inside the task pipeline) "
            "--", "-- result")
        assert_results_equal(frame(ref_frames[0]),
                             printed(got["frames"]["result"]),
                             "winsorized sums")
        # the clamped rows, exactly: a band edge that rounds differently
        # would move a row across it
        ref_clamped = int(line_after(ref_out,
                                     "rows clamped across all tasks: "))
        assert got["facts"]["clamped"] == ref_clamped == 400
        assert line_after(out, "rows clamped across all tasks: ") == "400"
    finally:
        jcodec._USER_CODECS.pop("winsorize", None)
        tcodec._USER_CODECS.pop("winsorize", None)


def test_winsorize_band_matches_jnp_nanquantile():
    """The port's band (`nanquantile`, a sort) equals ``jnp.nanquantile``
    bit for bit: float32 values with NaN padding, the example's q."""
    import jax.numpy as jnp

    from datafusion_distributed_tpu_torch.examples import (
        custom_execution_plan as ex,
    )

    rng = np.random.default_rng(7)
    for size, live in ((8192, 5000), (1000, 1000), (64, 1), (16, 2)):
        v = (rng.standard_t(df=2, size=size) * 100).astype(np.float32)
        v[live:] = np.nan
        for q in (0.01, 0.99, 0.5):
            ref = np.float32(jnp.nanquantile(jnp.asarray(v), q))
            got = ex.nanquantile(torch.from_numpy(v), q).numpy()
            assert got.tobytes() == ref.tobytes(), (size, live, q, got, ref)


def test_winsorize_codec_round_trip(monkeypatch):
    """The port's codec pair round-trips the node under the codec check
    (DFTPU_VERIFY_CODEC=1): same label, fingerprint and child."""
    from datafusion_distributed_tpu_torch.examples import (
        custom_execution_plan as ex,
    )
    from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
    from datafusion_distributed_tpu_torch.plan.physical import MemoryScanExec
    from datafusion_distributed_tpu_torch.runtime import codec as tcodec

    import pyarrow as pa

    monkeypatch.setenv("DFTPU_VERIFY_CODEC", "1")
    ex.register()
    try:
        t = arrow_to_table(pa.table({"k": np.arange(8), "v": np.ones(8)}),
                           device="cpu")
        node = ex.WinsorizeExec(MemoryScanExec([t], t.schema()), "v", 0.05)
        store = tcodec.TableStore()
        back = tcodec.decode_plan(tcodec.encode_plan(node, store), store)
        assert isinstance(back, ex.WinsorizeExec)
        assert (back.label(), back.column, back.q) == (node.label(), "v",
                                                       0.05)
    finally:
        tcodec._USER_CODECS.pop("winsorize", None)


def _reference_tree_codes(g) -> list:
    """The JAX package's verifier on its example's hand-built tree: the
    error codes (its coordinator refuses the tree under strict
    verification for them)."""
    from datafusion_distributed_tpu.io.parquet import arrow_to_table
    from datafusion_distributed_tpu.ops.aggregate import AggSpec
    from datafusion_distributed_tpu.ops.sort import SortKey
    from datafusion_distributed_tpu.plan.verify import verify_physical_plan
    from datafusion_distributed_tpu_torch.examples import (
        custom_partial_reduction_tree as ex,
    )

    t = arrow_to_table(ex.weather(ex.ROWS))
    aggs = [AggSpec("avg", "temp_c", "avg_temp"),
            AggSpec("max", "temp_c", "max_temp"),
            AggSpec("count_star", None, "readings")]
    n, m = g["N_TASKS"], g["M_GROUPS"]
    scan = g["MemoryScanExec"](g["partition_table"](t, n), t.schema())
    partial = g["HashAggregateExec"]("partial", ["station"], aggs, scan)
    narrow = g["CoalesceExchangeExec"](partial, n, num_consumers=m)
    red = g["HashAggregateExec"]("partial_reduce", ["station"], aggs, narrow)
    final = g["HashAggregateExec"]("final", ["station"], aggs,
                                   g["CoalesceExchangeExec"](red, n))
    staged = g["distribute_plan"](g["SortExec"]([SortKey("station")], final),
                                  g["DistributedConfig"](num_tasks=n))
    return sorted({d.code for d in verify_physical_plan(staged).errors()})


def test_custom_partial_reduction_tree(monkeypatch):
    ref_out, ref_frames, g = reference("custom_partial_reduction_tree",
                                       monkeypatch)
    out, got = port("custom_partial_reduction_tree", monkeypatch)
    assert (g["N_TASKS"], g["M_GROUPS"]) == (8, 2)
    assert got["facts"]["plan"] == between(
        ref_out, "-- hand-built reduction tree (as finalized by the "
        "planner) --", "-- result")
    ref = frame(ref_frames[0])
    assert_results_equal(ref, printed(got["frames"]["result"]), "in process")
    assert_results_equal(ref, printed(got["frames"]["coordinated"]),
                         "coordinated")
    # both verifiers flag the tree alike (ROADMAP §C)
    assert got["facts"]["verify_warnings"] == _reference_tree_codes(g) == [
        "DFTPU031"]
    assert "matches the pandas oracle" in ref_out
    assert "matches the plain oracle" in out


def test_custom_worker_routing(monkeypatch):
    ref_out, ref_frames, g = reference("custom_worker_routing", monkeypatch)
    out, got = port("custom_worker_routing", monkeypatch)
    facts = got["facts"]
    assert_results_equal(frame(ref_frames[0]), printed({
        k: v[:5] for k, v in got["frames"]["result"].items()}), "top five")
    assert facts["routes"] == g["ROUTES"] == [(-1, 0, "mem://worker-1")]
    assert facts["ran"] == facts["routes"]
    assert "  (-1, 0) -> mem://worker-1" in out.splitlines()


def test_routing_over_several_stages_matches_reference():
    """``bytes_per_task = 1`` fans the query out into several stages:
    every decision follows the hook (even stages to worker 0, odd to
    worker 1), the decisions equal the JAX package's, and every task ran
    on the worker it was routed to."""
    import pyarrow as pa

    from datafusion_distributed_tpu.runtime.coordinator import (
        Coordinator as JCoordinator,
        InMemoryCluster as JCluster,
    )
    from datafusion_distributed_tpu.sql.context import (
        SessionContext as JContext,
    )
    from datafusion_distributed_tpu_torch.examples import (
        custom_worker_routing as ex,
    )

    got = ex.run("cpu", bytes_per_task=1)
    facts = got["facts"]
    rng = np.random.default_rng(3)
    ctx = JContext()
    ctx.register_arrow("t", pa.table({
        "k": rng.integers(0, 30, ex.ROWS), "v": rng.normal(size=ex.ROWS)}))
    ctx.config.distributed_options["bytes_per_task"] = 1
    routes: list = []
    cluster = JCluster(2)
    coord = JCoordinator(resolver=cluster, channels=cluster,
                         route_tasks=ex.route_by_stage(routes))
    df = ctx.sql(ex.SQL)
    ref = df._strip_quals(df.collect_coordinated_table(
        coordinator=coord, num_tasks=4)).to_numpy()
    assert_results_equal(ref, got["frames"]["result"], "several stages")
    stages = {s for s, _t, _u in facts["routes"]}
    assert len(stages) >= 3, facts["routes"]
    assert facts["routes"] == sorted(routes)
    for stage, _task, url in facts["routes"]:
        assert url == f"mem://worker-{abs(stage) % 2}"
    assert facts["ran"] == facts["routes"]


def test_versioned_rolling_upgrade(monkeypatch):
    ref_out, ref_frames, g = reference("versioned_rolling_upgrade",
                                       monkeypatch)
    out, got = port("versioned_rolling_upgrade", monkeypatch)
    facts, frames = got["facts"], got["frames"]
    assert (g["OLD"], g["NEW"]) == ("1.0.3", "1.1.0")
    assert f"-- fleet on 1.0.3, epoch {facts['epochs'][0]} --" in ref_out
    assert_results_equal(
        frame(ref_frames[0]),
        printed({k: v[:3] for k, v in frames["before"].items()}),
        "before the roll")
    ref_refusal = line_after(ref_out, "mixed fleet: pinned coordinator "
                             "rejected (")[:-1]
    assert facts["refusal"] == ref_refusal
    assert "version skew" in facts["refusal"]
    assert facts["drained"] == [(f"mem://w{i}-1.0.3", 0) for i in range(3)]
    for i in range(3):
        assert identical(frames[f"step {i}"], frames["after"])
    assert facts["epochs"] == [3, 6, 9, 12]
    assert set(got["observed"]["drain_wait_s"]) == {
        url for url, _n in facts["drained"]}
    snap = facts["snapshot"]
    assert (f"-- roll complete: epoch {snap['epoch']}, "
            f"active={snap['active']} --") in ref_out
    assert snap["epoch"] == 12 and snap["draining"] == []
    assert_results_equal(frame(ref_frames[1]), printed(frames["after"]),
                         "after")
    assert out.splitlines()[0] == ref_out.splitlines()[0]


def test_work_unit_feed(monkeypatch):
    ref_out, _frames, _g = reference("work_unit_feed", monkeypatch)
    out, got = port("work_unit_feed", monkeypatch)
    got = got["facts"]
    assert got["sent"] == int(line_after(ref_out, "streamed ").split()[0])
    assert got["rows"] == int(line_after(ref_out, "rows fed: "))
    assert got["sum"] == int(line_after(ref_out, "sum(x) = ").split()[0])
    assert (got["sent"], got["rows"], got["sum"]) == (4, 100, 4950)
    assert out == ref_out


def test_localhost_cluster(monkeypatch):
    from datafusion_distributed_tpu.runtime import transport as jtransport

    ref_out, ref_frames, _g = reference("localhost_cluster", monkeypatch)
    out, got = port("localhost_cluster", monkeypatch)
    assert_results_equal(frame(ref_frames[0]),
                         printed(got["frames"]["result"]), "result")
    urls = got["observed"]["urls"]
    assert len(urls) == got["facts"]["workers"] == 2
    assert all(u.startswith("grpc://127.0.0.1:") for u in urls)
    assert got["facts"]["codec"] == jtransport.effective_codec("zstd")
    assert got["observed"]["wire"]["frames"] > 0
    assert f"wire codec: {got['facts']['codec']};" in out


def test_console_monitor(monkeypatch):
    ref_out, _frames, _g = reference("console_monitor", monkeypatch)
    out, got = port("console_monitor", monkeypatch)
    mod = _module("console_monitor")
    ref = [f.rstrip("\n") for f in ref_out.split(mod.CLEAR) if f]
    assert len(got["observed"]["frames"]) == len(ref) == 3
    # the section titles and worker rows, timestamps and process figures
    # left out
    assert got["facts"]["sections"] == [mod.sections(f) for f in ref]
    assert got["facts"]["workers"] == [mod.worker_rows(f) for f in ref]
    assert out.count(mod.CLEAR) == 3


def test_mesh_workers_cluster(monkeypatch):
    ref_out, ref_frames, _g = reference("mesh_workers_cluster", monkeypatch)
    out, got = port("mesh_workers_cluster", monkeypatch)
    facts = got["facts"]
    assert_results_equal(frame(ref_frames[0]),
                         printed(got["frames"]["result"]), "result")
    for url, (width, spans) in facts["workers"].items():
        assert (f"{url}: mesh width {width}, {spans} span programs "
                "executed") in ref_out.splitlines()
    assert (f"peer-plane boundaries: {facts['peer']} (coordinator row "
            f"bytes: {got['observed']['coordinator_bytes']})"
            ) in ref_out.splitlines()
    assert "matches single-node execution" in out


def test_mesh_spmd_query(monkeypatch):
    ref_out, ref_frames, _g = reference("mesh_spmd_query", monkeypatch)
    out, got = port("mesh_spmd_query", monkeypatch)
    assert got["facts"]["plan"] == between(ref_out, "-- staged plan --",
                                           "-- result")
    assert_results_equal(frame(ref_frames[0]),
                         printed(got["frames"]["result"]), "result")
    assert "device: cpu" in out


# ---------------------------------------------------------------------------
# the SPMD pair over four gloo ranks, and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["custom_partial_reduction_tree",
                                  "mesh_spmd_query"])
def test_spmd_examples_match_in_process_and_reference(spmd, monkeypatch,
                                                      name):
    """Each of four ranks' result of ``run(mesh=make_mesh())`` is byte
    for byte rank 0's in-process run at 4 tasks, and equals the JAX
    package's example (at its own 8 tasks)."""
    _out, ref_frames, _g = reference(name, monkeypatch)
    ref = frame(ref_frames[0])
    inproc = _case(spmd, 0, "examples")[name]["in_process"]
    assert_results_equal(ref, printed(inproc["frames"]["result"]),
                         f"{name} in process")
    for rank in range(NT):
        got = _case(spmd, rank, "examples")[name]["spmd"]
        assert identical(got["frames"]["result"],
                         inproc["frames"]["result"]), (name, rank)
        assert got["facts"]["plan"] == inproc["facts"]["plan"], (name, rank)


@pytest.mark.parametrize("name,title", [
    ("custom_partial_reduction_tree",
     "-- result (one program over 2 ranks) --"),
    ("mesh_spmd_query", "-- result (one SPMD program over 2 ranks) --")])
def test_spmd_example_over_spawned_ranks(monkeypatch, name, title):
    """``main(["--device", "cpu", "--ranks", "2"])`` spawns two ranks of a
    gloo group (`_common.spawn_ranks`, `rank_main`): rank 0's result, as
    returned and as printed, equals the in-process run's."""
    mod = _module(name)
    spawned = {}
    real = mod.spawn_ranks

    def recorded(*a, **kw):
        spawned.update(real(*a, **kw))
        return spawned

    monkeypatch.setattr(mod, "spawn_ranks", recorded)
    out, got = port(name, monkeypatch, "--ranks", "2")
    inproc = got["frames"]["result"]
    mine = spawned["frames"]["result"]
    assert_results_equal(inproc, mine, f"{name} over 2 ranks")
    assert len(spawned["facts"]["plan"]) > 0
    lines = out.splitlines()
    i = lines.index(title) + 1
    shown = _module("_common").show(mine).splitlines()
    assert lines[i:i + len(shown)] == shown


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                              name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).run()
