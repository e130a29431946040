"""The program's spans read from a profile (`harness/spans.py`) and the
per-layer metrics that read them, on hand-built profiler events: what is
put down to which span, and that the program's ranges move none of the
readings `harness/trace.py` gives."""

import pytest
from torch.autograd import DeviceType

from harness import cells, roofline, spans, trace

MS = 1_000_000  # ns


class _Event:
    """The part of a kineto event the harness reads."""

    def __init__(self, name, device, start, end, corr=0, thread=1):
        self._t = (name, device, start, end, corr, thread)

    def name(self):
        return self._t[0]

    def device_type(self):
        return DeviceType.CUDA if self._t[1] else DeviceType.CPU

    def start_ns(self):
        return self._t[2]

    def duration_ns(self):
        return self._t[3] - self._t[2]

    def correlation_id(self):
        return self._t[4]

    def start_thread_id(self):
        return self._t[5]


class _Profile:
    def __init__(self, events):
        class Results:
            def events(self):
                return events

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


def _ms(a, b):
    return int(a * MS), int(b * MS)


# the benchmark's ranges of two queries, with their device mirrors
BENCH = [
    ("portbench:plan:q1", 0, 1), ("portbench:execute:q1", 1, 9),
    ("portbench:to_host:q1", 9, 10), ("portbench:plan:q2", 12, 13),
    ("portbench:execute:q2", 13, 19), ("portbench:to_host:q2", 19, 20),
]
# the program's spans, as the port opens them (function-scope: no mirror)
PROGRAM = [
    ("dftpu:session:sql", 0.1, 0.5), ("dftpu:planner:physical_plan", 0.6, 0.9),
    ("dftpu:executor:attempt", 1.1, 8.9),
    ("dftpu:planner:physical_plan", 1.15, 1.18),
    ("dftpu:op:HashAggregate", 1.2, 8.0), ("dftpu:op:Filter", 1.25, 1.95),
    ("dftpu:expr:like", 1.3, 1.9), ("dftpu:kernel:build_group_ids", 2.0, 2.5),
    ("dftpu:executor:flags", 8.2, 8.8), ("dftpu:table:to_host", 9.1, 9.9),
    ("dftpu:session:sql", 12.1, 12.4), ("dftpu:executor:attempt", 13.1, 18.5),
    ("dftpu:op:Sort", 13.2, 18.0),
]
# runtime calls (name, at ms, correlation id) and the device work they
# launched (name, from, to ms, correlation id)
CALLS = [("cudaLaunchKernel", 1.5, 11), ("cudaStreamSynchronize", 1.7, 16),
         ("cudaLaunchCooperativeKernel", 2.2, 12),
         ("cudaMemcpyAsync", 8.5, 13), ("cudaStreamSynchronize", 8.6, 17),
         ("cudaLaunchKernel", 13.5, 14), ("cudaLaunchKernel", 25.0, 15)]
DEVICE = [
    ("void at::native::elementwise_kernel<128>(int)", 2, 4, 11),
    ("(anonymous namespace)::group_build_kernel("
     "(anonymous namespace)::Build)", 4, 6, 12),
    ("Memcpy DtoH (Device -> Pageable)", 9, 10, 13),
    ("(anonymous namespace)::probe_l2((anonymous namespace)::Probe)",
     14, 16, 14),
    ("void at::native::reduce_kernel<512>(int)", 30, 31, 15),
]
QUERIES = [{"name": "q1", "plan": 0.001, "execute": 0.008, "to_host": 0.001},
           {"name": "q2", "plan": 0.003, "execute": 0.006, "to_host": 0.001}]
KERNELS = {"hash_table.cu": ["group_aggregate_kernel", "group_build_kernel"],
           "probe.cu": ["pack_records", "probe_l2", "probe_smem"]}


def _events(program=True, mirrors=False):
    out = []
    for name, a, b in BENCH:
        out += [_Event(name, False, *_ms(a, b)), _Event(name, True, *_ms(a, b))]
    if program:
        out += [_Event(name, False, *_ms(a, b)) for name, a, b in PROGRAM]
    if mirrors:  # what a user-scope range would leave on the device
        out += [_Event(name, True, *_ms(a, b)) for name, a, b in PROGRAM]
    out += [_Event(name, False, *_ms(at, at + 0.01), corr)
            for name, at, corr in CALLS]
    out += [_Event(name, True, *_ms(a, b), corr) for name, a, b, corr in DEVICE]
    return out


def _records(program=True, mirrors=False):
    prof = _Profile(_events(program, mirrors))
    rec = trace.records(prof, QUERIES, KERNELS, {(1000, 2, 4096): 3},
                        {(500, 2, 1, (64, 64)): 2}, 1e9)
    rec.update(spans.records(prof))
    return rec


def _span(rec, i):
    return None if i is None else rec["spans"][i][:2]


def test_spans_nest_and_know_their_query():
    rec = _records()
    by = {(s[0], s[1], s[4]): s for s in rec["spans"]}
    like = by[("expr", "like", int(1.3 * MS))]
    assert like[2] == "q1"
    chain = []
    i = rec["spans"].index(like)
    while i is not None:
        chain.append(rec["spans"][i][:2])
        i = rec["spans"][i][6]
    assert chain == [("expr", "like"), ("op", "Filter"),
                     ("op", "HashAggregate"), ("executor", "attempt")]
    assert by[("op", "Sort", int(13.2 * MS))][2] == "q2"
    assert by[("session", "sql", int(0.1 * MS))][6] is None


def test_device_work_goes_to_the_span_that_launched_it():
    rec = _records()
    assert [_span(rec, a[3]) for a in rec["attributed"]] == [
        ("expr", "like"), ("kernel", "build_group_ids"),
        ("executor", "flags"), ("op", "Sort"), None]
    # the reduce at 30 ms lies outside the window [0, 20]
    assert spans.unattributed_seconds(rec) == 0.0
    # the aggregate's own work and its kernel wrapper's, not the filter's
    # below it
    assert spans.device_seconds(rec, "op", "HashAggregate") == \
        pytest.approx(2e-3)
    assert spans.device_seconds(rec, "op", "Filter") == pytest.approx(2e-3)
    assert spans.device_seconds(rec, "kernel", "build_group_ids") == \
        pytest.approx(2e-3)
    assert [(_n, _span(rec, s)) for _n, _t, _ts, s in rec["sync_calls"]] == [
        ("cudaStreamSynchronize", ("expr", "like")),
        ("cudaMemcpyAsync", ("executor", "flags")),
        ("cudaStreamSynchronize", ("executor", "flags"))]


def test_a_ranges_device_mirror_is_no_device_work():
    rec = _records(mirrors=True)
    assert len(rec["attributed"]) == len(DEVICE)


EXISTING = ["session.plan_ms", "executor.syncs_per_query",
            "operators.device_ms_per_query", "kernels.build_roofline",
            "device.idle_share_pct"]


@pytest.mark.parametrize("name", EXISTING)
def test_the_programs_ranges_move_no_existing_reading(name):
    without, with_ = _records(program=False), _records(program=True)
    assert cells.reader(name).read(with_) == cells.reader(name).read(without)
    assert cells.reader(name).read(with_) is not None
    assert trace.idle_gaps(with_) == trace.idle_gaps(without)
    assert trace.breakdown(with_) == trace.breakdown(without)


def test_idle_by_span():
    idle = spans.idle_by_span(_records())
    # busy [2, 6] + [9, 10] + [14, 16] of the window [0, 20]: each idle
    # stretch goes to the innermost span open on the host then, and where
    # none was, to the benchmark's range, as `trace.idle_gaps` labels it
    assert idle == pytest.approx({
        "session:sql q1": 0.4e-3, "planner:physical_plan q1": 0.33e-3,
        "executor:attempt q1": 0.37e-3, "op:HashAggregate q1": 2.1e-3,
        "op:Filter q1": 0.1e-3, "expr:like q1": 0.6e-3,
        "executor:flags q1": 0.6e-3, "plan q1": 0.3e-3,
        "execute q1": 0.2e-3, "between queries": 2e-3,
        "session:sql q2": 0.3e-3, "plan q2": 0.7e-3, "execute q2": 0.6e-3,
        "executor:attempt q2": 0.6e-3, "op:Sort q2": 2.8e-3,
        "to_host q2": 1e-3}, abs=1e-8)
    assert sum(idle.values()) == pytest.approx(
        sum(trace.idle_gaps(_records()).values()))
    assert spans.top(idle, 2) == [["op:Sort q2", pytest.approx(2.8e-3)],
                                  ["op:HashAggregate q1",
                                   pytest.approx(2.1e-3)]]


def read(name, rec):
    return cells.reader(name).read(rec)


def test_operator_syncs_are_those_inside_an_op_span():
    rec = _records()
    assert read("executor.operator_syncs_per_query", rec) == 0.5
    assert read("executor.syncs_per_query", rec) == 1.5
    assert read("executor.operator_syncs_per_query",
                _records(program=False)) is None


def test_aggregate_device_time():
    assert read("operators.aggregate_device_ms_per_query", _records()) == \
        pytest.approx(1.0)
    rec = _records()
    rec["spans"] = [s for s in rec["spans"] if s[1] != "HashAggregate"]
    assert read("operators.aggregate_device_ms_per_query", rec) is None


def test_group_build_roofline_counts_live_rows_over_the_wrappers_time():
    rec = _records()
    rec["live_build_rows"] = {(1000, 2, 4096): 1500}
    need = 3 * roofline.build_bytes(1000, 2, 4096) + 1500 * (4 * 2 + 4)
    got = read("kernels.group_build_roofline", rec)
    assert got == pytest.approx(100.0 * need / 1e9 / 2e-3)
    # the symbol's share counts fewer bytes over the same time
    assert read("kernels.build_roofline", rec) < got
    rec["live_build_rows"] = None
    assert read("kernels.group_build_roofline", rec) is None


TOTALS = {"session:sql": (2, 0.0006), "planner:physical_plan": (4, 0.0004),
          "executor:attempt:overflow": (1, 0.005),
          "executor:attempt:ok": (2, 0.013), "expr:like": (1, 0.0006),
          "expr:unify": (1, 0.0002), "op:Filter": (1, 0.0007)}


@pytest.mark.parametrize("name, expected", [
    ("session.plan_span_ms", 0.5), ("executor.retry_ms_per_query", 2.5),
    ("operators.host_string_ms_per_query", 0.4)])
def test_host_span_readers_read_the_programs_totals(monkeypatch, name,
                                                    expected):
    rec = _records()
    monkeypatch.setattr(spans, "program_totals", lambda: TOTALS)
    assert read(name, rec) == pytest.approx(expected)
    # the CPU's host time is all of its work: nothing read there
    assert read(name, dict(rec, device=[])) is None
    monkeypatch.setattr(spans, "program_totals", lambda: None)
    assert read(name, rec) is None


def test_program_totals_of_the_port():
    totals = spans.program_totals()
    assert isinstance(totals, dict)
    assert isinstance(spans.live_build_rows(), dict)
