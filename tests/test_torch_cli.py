"""The port's REPL (cli.py) against the reference's, on the CPU: ``-c``
runs one query and prints its rows, equal to the reference's printout; the
REPL's commands (``\\d``, ``\\dist on`` over --tasks tasks, ``\\explain``,
``\\explain_dist``, an unknown command, a failing query) answer as the
reference's do. Both sessions hold the same TPC-H tables (SF 0.002, seed
7) from one generated copy."""

import io
import re

import pytest
import torch

from datafusion_distributed_tpu import cli as jcli
from datafusion_distributed_tpu.data import tpchgen as jtpch
from datafusion_distributed_tpu_torch import cli as tcli
from datafusion_distributed_tpu_torch import precision as tprec
from datafusion_distributed_tpu_torch.data import tpchgen as ttpch

torch.set_num_threads(1)

Q = ("select l_returnflag, l_linestatus, count(*) as n, sum(l_quantity) "
     "as qty from lineitem where l_shipdate <= date '1998-09-02' group by "
     "l_returnflag, l_linestatus order by l_returnflag, l_linestatus")


def _rows(text: str) -> list:
    """The printed table rows, with the timing footer's seconds masked."""
    return [re.sub(r"in \d+\.\d+s", "in Ts", ln)
            for ln in text.splitlines() if ln.strip()]


def _same_rows(port: list, ref: list) -> bool:
    """Equal printed rows: every token exact, except that a float is held
    at `precision.test_rtol()` (the two packages sum in other orders)."""
    if len(port) != len(ref):
        return False
    for a, b in zip(port, ref):
        ta, tb = a.split(), b.split()
        if len(ta) != len(tb):
            return False
        for x, y in zip(ta, tb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                return False
            if "." not in x or abs(fx - fy) > tprec.test_rtol() * abs(fy):
                return False
    return True


def _run(module, argv, monkeypatch, capsys, stdin=None) -> str:
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = module.main(argv)
    assert rc == 0
    return capsys.readouterr().out


@pytest.fixture
def same_tables(monkeypatch):
    """Both packages' ``--tpch`` read one generated copy of the tables."""
    arrow = jtpch.gen_tpch(0.002, 7)
    monkeypatch.setattr(jtpch, "register_tpch", lambda ctx, sf=0.01: [
        ctx.register_arrow(n, t) for n, t in arrow.items()])
    monkeypatch.setattr(ttpch, "register_tpch", lambda ctx, sf=0.01: [
        ctx.register_arrow(n, t) for n, t in arrow.items()])


def test_command_prints_the_references_rows(same_tables, monkeypatch,
                                            capsys):
    ref = _run(jcli, ["--tpch", "0.002", "-c", Q], monkeypatch, capsys)
    port = _run(tcli, ["--device", "cpu", "--tpch", "0.002", "-c", Q],
                monkeypatch, capsys)
    assert _same_rows(_rows(port), _rows(ref)), (port, ref)
    assert "(4 rows in Ts)" in _rows(port)


def test_repl_commands_answer_as_the_references(same_tables, monkeypatch,
                                                capsys):
    script = "\n".join([
        "\\d",
        "\\dist on",
        "select n_regionkey, count(*) as n from nation",
        "group by n_regionkey order by n_regionkey;",
        "\\dist off",
        "select count(*) as c from orders;",
        "\\explain_dist select o_orderstatus, count(*) from orders "
        "group by o_orderstatus",
        "\\bogus",
        "\\q",
    ]) + "\n"
    ref = _run(jcli, ["--tpch", "0.002", "--tasks", "4"], monkeypatch,
               capsys, stdin=script)
    port = _run(tcli, ["--device", "cpu", "--tpch", "0.002", "--tasks", "4"],
                monkeypatch, capsys, stdin=script)
    # the banner names the device family; every other line is equal
    ref_rows, port_rows = (
        [ln for ln in _rows(out) if "distributed query engine" not in ln]
        for out in (ref, port))
    assert port_rows == ref_rows
    assert port_rows[0].startswith("registered TPC-H")
    assert "GPU distributed query engine" in port
    assert any("distributed)" in ln for ln in port_rows)
    assert any("unknown command \\bogus" in ln for ln in port_rows)


def test_failing_query_reports_and_the_repl_goes_on(same_tables,
                                                    monkeypatch, capsys):
    script = "select nope from nation;\nselect count(*) as c from region;\n"
    for module, argv in ((jcli, []), (tcli, ["--device", "cpu"])):
        out = _run(module, argv + ["--tpch", "0.002"], monkeypatch, capsys,
                   stdin=script)
        assert "(1 rows in" in out
    err = capsys.readouterr().err
    assert err == ""


def test_bad_register_spec_is_a_usage_error(capsys):
    for module, argv in ((jcli, []), (tcli, ["--device", "cpu"])):
        assert module.main(argv + ["--register", "nopath"]) == 2
    assert capsys.readouterr().err.count("bad --register") == 2


def test_register_parquet_and_query(tmp_path, monkeypatch, capsys):
    import pyarrow as pa
    import pyarrow.parquet as pq

    p = tmp_path / "t.parquet"
    pq.write_table(pa.table({"x": list(range(10))}), p)
    outs = []
    for module, argv in ((jcli, []), (tcli, ["--device", "cpu"])):
        outs.append(_run(module, argv + ["--register", f"t={p}", "-c",
                                         "select sum(x) as s from t"],
                         monkeypatch, capsys))
    assert _rows(outs[1]) == _rows(outs[0])
    assert "45" in _rows(outs[1])
