"""The per-layer metrics' arithmetic on synthetic profiler records."""

import pytest

from harness import cells, roofline, trace

MS = 1_000_000  # ns


def _records(**over):
    rec = {
        # two queries, each plan 0-1 ms, execute 1-9 ms, to_host 9-10 ms
        "ranges": [("plan", "q1", 0, 1 * MS), ("execute", "q1", 1 * MS, 9 * MS),
                   ("to_host", "q1", 9 * MS, 10 * MS),
                   ("plan", "q2", 12 * MS, 13 * MS),
                   ("execute", "q2", 13 * MS, 19 * MS),
                   ("to_host", "q2", 19 * MS, 20 * MS)],
        "window_ns": (0, 20 * MS),
        "device": [
            ("void at::native::elementwise_kernel<128>(int)", 2 * MS, 4 * MS),
            ("(anonymous namespace)::group_build_kernel("
             "(anonymous namespace)::Build)", 3 * MS, 6 * MS),
            ("Memcpy DtoH (Device -> Pageable)", 9 * MS, 10 * MS),
            ("(anonymous namespace)::probe_l2((anonymous namespace)::Probe)",
             14 * MS, 16 * MS),
            ("void at::native::reduce_kernel<512>(int)", 30 * MS, 31 * MS),
        ],
        "runtime": {"cudaStreamSynchronize": 3, "cudaMemcpyAsync": 5,
                    "cudaLaunchKernel": 40, "cudaDeviceSynchronize": 0},
        "queries": [{"name": "q1", "plan": 0.001, "execute": 0.008,
                     "to_host": 0.001},
                    {"name": "q2", "plan": 0.003, "execute": 0.006,
                     "to_host": 0.001}],
        "kernels": {"hash_table.cu": ["group_aggregate_kernel",
                                      "group_build_kernel"],
                    "probe.cu": ["pack_records", "probe_l2", "probe_smem"]},
        "build_shapes": {(1000, 2, 4096): 3},
        "probe_shapes": {(500, 2, 1, (64, 64)): 2},
        "hbm_bytes_per_s": 1e9,
    }
    rec.update(over)
    return rec


def read(name, rec):
    return cells.reader(name).read(rec)


def test_busy_and_idle():
    rec = _records()
    # busy: [2, 6] + [9, 10] + [14, 16] inside [0, 20]; the kernel at 30
    # lies outside the window
    assert trace.busy_s(rec) == pytest.approx(7e-3)
    assert trace.window_s(rec) == pytest.approx(20e-3)
    assert read("device.idle_share_pct", rec) == pytest.approx(65.0)


def test_idle_gaps_labelled_by_the_open_range():
    gaps = trace.idle_gaps(_records())
    assert gaps == pytest.approx({
        "plan q1": 1e-3, "execute q1": 4e-3, "between queries": 2e-3,
        "plan q2": 1e-3, "execute q2": 4e-3, "to_host q2": 1e-3})
    assert sum(gaps.values()) == pytest.approx(13e-3)


def test_breakdown_lists_at_most_ten():
    b = trace.breakdown(_records())
    assert b["device_ops"][0] == [
        "(anonymous namespace)::group_build_kernel("
        "(anonymous namespace)::Build)", pytest.approx(3e-3)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_plan_and_syncs():
    rec = _records()
    assert read("session.plan_ms", rec) == pytest.approx(2.0)
    assert read("executor.syncs_per_query", rec) == pytest.approx(4.0)


def test_operators_leave_out_the_ports_kernels():
    # all device time 2 + 3 + 1 + 2 + 1 = 9 ms, the port's kernels 5 ms
    assert read("operators.device_ms_per_query", _records()) == \
        pytest.approx(2.0)


def test_build_roofline():
    need = 3 * (5 * 1000 + 4096 * (4 * 2 + 1))
    assert roofline.build_bytes(1000, 2, 4096) == 5 * 1000 + 4096 * 9
    got = read("kernels.build_roofline", _records())
    assert got == pytest.approx(100.0 * need / 1e9 / 3e-3)


def test_probe_roofline():
    need = 2 * 5 * 500 * 2
    got = read("kernels.probe_roofline", _records())
    assert got == pytest.approx(100.0 * need / 1e9 / 2e-3)


@pytest.mark.parametrize("name", ["kernels.build_roofline",
                                  "kernels.probe_roofline"])
def test_rooflines_are_silent_without_launches(name):
    rec = _records(build_shapes={}, probe_shapes={}, device=[])
    assert read(name, rec) is None
    assert read("device.idle_share_pct", rec) is None


def test_unknown_card_has_no_roofline():
    assert roofline.hbm_bytes_per_s("cpu") is None
    assert read("kernels.build_roofline",
                _records(hbm_bytes_per_s=None)) is None


def test_kernel_of_matches_whole_symbols():
    syms = ["probe_l2", "probe_smem"]
    assert trace.kernel_of("(anonymous namespace)::probe_l2(P)", syms)
    assert trace.kernel_of("probe_smem(P)", syms) == "probe_smem"
    assert trace.kernel_of("(anonymous namespace)::probe_l2x(P)", syms) \
        is None


def test_kernel_symbols_read_from_the_ports_sources():
    from harness import program

    syms = trace.kernel_symbols(program.csrc())
    assert "group_build_kernel" in syms["hash_table.cu"]
    assert {"probe_l2", "probe_smem", "pack_records"} <= set(syms["probe.cu"])


@pytest.mark.parametrize("name", ["session.plan_ms", "executor.syncs_per_query",
                                  "operators.device_ms_per_query",
                                  "kernels.build_roofline",
                                  "kernels.probe_roofline",
                                  "device.idle_share_pct"])
def test_power_readings_are_the_same_reading(name):
    rec = _records()
    assert read(name + ".power", rec) == read(name, rec)
