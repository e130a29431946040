"""The port's exchange data plane (`parallel/exchange.py`) against the
reference's collectives on the 8-device CPU mesh of tests/conftest.py.

The same numpy-seeded per-task tables go through each reference function
under `shard_map` and through the port's function, which takes the list of
producer tables and returns the list of consumer tables. Every consumer
task's table must be equal byte for byte: data and validity (padding rows
included), `num_rows`, capacity, dictionary, and the overflow flag. The
tables hold nulls, dictionary strings, floats with NaN and -0.0, booleans,
and empty and full tasks, for T in {2, 8}. The port's functions get the
producers whole, and cut to their live rows with the padded capacity
beside them, as an exchange node passes large producers. A subprocess
repeats the T = 8 cases in DFTPU_PRECISION=x64 mode, where the integer
and float columns are int64 and float64."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from datafusion_distributed_tpu.ops.sort import SortKey as JSortKey
from datafusion_distributed_tpu.ops.table import (
    Column as JColumn,
    Dictionary as JDictionary,
    Table as JTable,
)
from datafusion_distributed_tpu.parallel import exchange as jex
from datafusion_distributed_tpu.runtime.mesh_executor import AXIS, make_mesh
from datafusion_distributed_tpu.schema import DataType as JDataType
from datafusion_distributed_tpu_torch import precision as tprec
from datafusion_distributed_tpu_torch.ops.sort import SortKey as TSortKey
from datafusion_distributed_tpu_torch.ops.table import (
    Column as TColumn,
    Dictionary as TDictionary,
    Table as TTable,
)
from datafusion_distributed_tpu_torch.parallel import exchange as tex
from datafusion_distributed_tpu_torch.schema import DataType as TDataType

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu"],
                 dtype=object)
CAP = 32


def _columns(rng, cap: int):
    """One task's columns as numpy ([cap] each, garbage past the live rows):
    name -> (data, validity or None, DataType name)."""
    x64 = tprec.MODE == "x64"
    ity = np.int64 if x64 else np.int32
    fty = np.float64 if x64 else np.float32
    f = rng.normal(size=cap).astype(fty)
    f[rng.random(cap) < 0.1] = np.nan
    f[rng.random(cap) < 0.1] = -0.0
    f[rng.random(cap) < 0.1] = 0.0
    return {
        "k": (rng.integers(-6, 6, cap).astype(ity), rng.random(cap) > 0.15,
              "int64"),
        "s": (rng.integers(0, len(WORDS), cap).astype(np.int32),
              rng.random(cap) > 0.1, "string"),
        "f": (f, rng.random(cap) > 0.1, "float64"),
        "i": (rng.integers(-2**30, 2**30, cap).astype(ity), None, "int32"),
        "b": (rng.random(cap) < 0.5, None, "bool"),
    }


def _task_data(seed: int, num_tasks: int, cap: int = CAP):
    """Per-task numpy columns and row counts: task 0 full, task 1 empty,
    the rest random."""
    rng = np.random.default_rng(seed)
    rows = [cap, 0] + [int(rng.integers(0, cap + 1))
                       for _ in range(num_tasks - 2)]
    return [_columns(rng, cap) for _ in range(num_tasks)], rows[:num_tasks]


def _tables(data, rows):
    """The same per-task tables in both packages."""
    jd, td = JDictionary(WORDS), TDictionary(WORDS)
    jt, tt = [], []
    for cols, n in zip(data, rows):
        jc, tc = [], []
        for d, v, ty in cols.values():
            s = ty == "string"
            jc.append(JColumn(jnp.asarray(d),
                              None if v is None else jnp.asarray(v),
                              JDataType(ty), jd if s else None))
            tc.append(TColumn(torch.from_numpy(d.copy()),
                              None if v is None else torch.from_numpy(v.copy()),
                              TDataType(ty), td if s else None))
        jt.append(JTable(tuple(cols), tuple(jc),
                         jnp.asarray(n, dtype=jnp.int32)))
        tt.append(TTable(tuple(cols), tuple(tc),
                         torch.tensor(n, dtype=torch.int32)))
    return jt, tt


def _on_mesh(fn, jtables, returns_flag: bool):
    """Run ``fn(local_table)`` on every task of a mesh as wide as the list;
    -> (per-task tables, per-task flags or None)."""
    t = len(jtables)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jtables)

    def step(s):
        out = fn(jax.tree.map(lambda x: x[0], s))
        return jax.tree.map(lambda x: x[None], out)

    out = jax.jit(shard_map(step, mesh=make_mesh(t), in_specs=(P(AXIS),),
                            out_specs=P(AXIS), check_rep=False))(stacked)
    table, flags = out if returns_flag else (out, None)
    # sliced on the host: an eager jax slice turns -0.0 into 0.0 on the CPU
    per_task = [jax.tree.map(lambda x, i=i: np.asarray(x)[i], table)
                for i in range(t)]
    return per_task, (np.asarray(flags) if flags is not None else None)


def _assert_tables_identical(jt, tt, what: str) -> None:
    assert tt.names == jt.names, what
    assert tt.capacity == jt.capacity, what
    assert int(tt.num_rows) == int(jt.num_rows), what
    for name, a, b in zip(jt.names, jt.columns, tt.columns):
        da, db = np.asarray(a.data), b.data.numpy()
        assert da.dtype == db.dtype, (what, name)
        assert da.tobytes() == db.tobytes(), (what, name)
        assert (a.validity is None) == (b.validity is None), (what, name)
        if a.validity is not None:
            assert np.array_equal(np.asarray(a.validity), b.validity.numpy()), \
                (what, name)
        if a.dictionary is not None:
            assert list(b.dictionary.values) == list(a.dictionary.values), \
                (what, name)


def _forms(tt):
    """The port's two inputs: the whole producer tables, and their live
    rows with the padded capacity beside them (what an exchange node
    passes for large producers)."""
    return [(tt, None), ([tex.live_prefix(t) for t in tt], tt[0].capacity)]


def _assert_all(jouts, touts, what: str) -> None:
    assert len(touts) == len(jouts), what
    for j, (a, b) in enumerate(zip(jouts, touts)):
        _assert_tables_identical(a, b, f"{what}, consumer {j}")


SHUFFLE_CASES = [  # (keys, per_dest_capacity)
    (["k"], CAP), (["k", "s"], CAP), (["f"], 16), (["b", "i"], CAP),
    (["k"], 4),  # overflow
]


def check_shuffle(num_tasks: int, keys, per_dest: int, seed: int) -> None:
    data, rows = _task_data(seed, num_tasks)
    jt, tt = _tables(data, rows)
    jo, jflags = _on_mesh(
        lambda t: jex.shuffle_exchange(t, keys, AXIS, num_tasks, per_dest),
        jt, True)
    what = f"shuffle T={num_tasks} keys={keys} per_dest={per_dest}"
    assert jflags.all() or not jflags.any(), what  # pmax: one verdict
    for tables, cap in _forms(tt):
        to, tflag = tex.shuffle_exchange(tables, keys, num_tasks, per_dest,
                                         cap)
        _assert_all(jo, to, f"{what} cap={cap}")
        assert bool(tflag) == bool(jflags.any()), what


RANGE_CASES = [  # [(name, ascending, nulls_first)]
    [("k", True, False)], [("k", False, True)], [("f", True, True)],
    [("f", False, False)], [("s", False, True), ("k", True, False)],
    [("b", True, False), ("f", False, True), ("i", True, False)],
]


def check_range_shuffle(num_tasks: int, keys, seed: int,
                        per_dest: int = CAP) -> None:
    data, rows = _task_data(seed, num_tasks)
    jt, tt = _tables(data, rows)
    jkeys = [JSortKey(n, a, nf) for n, a, nf in keys]
    tkeys = [TSortKey(n, a, nf) for n, a, nf in keys]
    jo, jflags = _on_mesh(
        lambda t: jex.range_shuffle_exchange(t, jkeys, AXIS, num_tasks,
                                             per_dest, samples_per_task=8),
        jt, True)
    what = f"range shuffle T={num_tasks} keys={keys}"
    for tables, cap in _forms(tt):
        to, tflag = tex.range_shuffle_exchange(
            tables, tkeys, num_tasks, per_dest, samples_per_task=8,
            capacity=cap)
        _assert_all(jo, to, f"{what} cap={cap}")
        assert bool(tflag) == bool(jflags.any()), what


def check_order_encode(seed: int) -> None:
    data, rows = _task_data(seed, 1)
    jt, tt = _tables(data, rows)
    for name in ("k", "s", "f", "i", "b"):
        for asc in (True, False):
            for nf in (True, False):
                a = np.asarray(jex._order_encode(jt[0].column(name), asc, nf))
                b = tex._order_encode(tt[0].column(name), asc, nf).numpy()
                # the port's code is the reference's shifted into int64:
                # the same order and the same ties
                ia, ib = np.argsort(a, kind="stable"), np.argsort(b,
                                                                kind="stable")
                assert np.array_equal(ia, ib), (name, asc, nf)
                assert np.array_equal(a[:, None] == a[None, :],
                                      b[:, None] == b[None, :]), (name, asc, nf)


def check_broadcast(num_tasks: int, seed: int, coalesce: bool) -> None:
    data, rows = _task_data(seed, num_tasks)
    jt, tt = _tables(data, rows)
    jfn = jex.coalesce_exchange if coalesce else jex.broadcast_exchange
    tfn = tex.coalesce_exchange if coalesce else tex.broadcast_exchange
    jo, _ = _on_mesh(lambda t: jfn(t, AXIS, num_tasks), jt, False)
    for tables, cap in _forms(tt):
        _assert_all(jo, tfn(tables, num_tasks, cap),
                    f"{'coalesce' if coalesce else 'broadcast'} "
                    f"T={num_tasks} cap={cap}")


def check_group_coalesce(num_tasks: int, consumers: int, seed: int) -> None:
    data, rows = _task_data(seed, num_tasks)
    jt, tt = _tables(data, rows)
    jo, _ = _on_mesh(
        lambda t: jex.group_coalesce_exchange(t, AXIS, num_tasks, consumers),
        jt, False)
    what = f"group coalesce T={num_tasks} M={consumers}"
    if -(-num_tasks // consumers) == 1:  # g = 1: unchanged, whole tables
        to = tex.group_coalesce_exchange(tt, num_tasks, consumers)
        assert all(a is b for a, b in zip(to, tt))
        _assert_all(jo, to, what)
        return
    for tables, cap in _forms(tt):
        to = tex.group_coalesce_exchange(tables, num_tasks, consumers, cap)
        _assert_all(jo, to, f"{what} cap={cap}")


def check_compact(seed: int) -> None:
    data, rows = _task_data(seed, 2)
    jt, tt = _tables(data, rows)
    keep = np.random.default_rng(seed).random(CAP) < 0.4
    a = jex._compact_with_mask(jt[0], jnp.asarray(keep))
    b = tex._compact_with_mask(tt[0], torch.from_numpy(keep))
    _assert_tables_identical(a, b, "compact")


def check_all() -> None:
    """The cases at T = 8 (the x64 subprocess runs this)."""
    for i, (keys, per_dest) in enumerate(SHUFFLE_CASES):
        check_shuffle(8, keys, per_dest, seed=80 + i)
    for i, keys in enumerate(RANGE_CASES):
        check_range_shuffle(8, keys, seed=160 + i)
    check_broadcast(8, 38, coalesce=False)
    check_group_coalesce(8, 3, 53)
    check_order_encode(60)
    check_compact(61)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_tasks", [2, 8])
@pytest.mark.parametrize("case", range(len(SHUFFLE_CASES)))
def test_shuffle_matches_reference(num_tasks, case):
    keys, per_dest = SHUFFLE_CASES[case]
    check_shuffle(num_tasks, keys, per_dest, seed=10 * num_tasks + case)


def test_shuffle_overflow_flag():
    """All rows on one key: one destination bucket overflows in both
    packages, and the rows past per_dest_capacity are dropped alike."""
    arrow_rows = 64
    jd = [{"k": (np.zeros(CAP, np.int32), None, "int32")}
          for _ in range(8)]
    jt, tt = _tables(jd, [arrow_rows // 8] * 8)
    jo, jflags = _on_mesh(
        lambda t: jex.shuffle_exchange(t, ["k"], AXIS, 8, 2), jt, True)
    assert jflags.all()
    for tables, cap in _forms(tt):
        to, tflag = tex.shuffle_exchange(tables, ["k"], 8, 2, cap)
        assert bool(tflag)
        _assert_all(jo, to, f"overflow cap={cap}")


@pytest.mark.parametrize("num_tasks", [2, 8])
@pytest.mark.parametrize("case", range(len(RANGE_CASES)))
def test_range_shuffle_matches_reference(num_tasks, case):
    check_range_shuffle(num_tasks, RANGE_CASES[case],
                        seed=20 * num_tasks + case)


def test_range_shuffle_overflow_matches_reference():
    check_range_shuffle(8, [("k", True, False)], seed=77, per_dest=3)


def test_order_encode_orders_as_the_reference():
    check_order_encode(60)


@pytest.mark.parametrize("coalesce", [False, True],
                         ids=["broadcast", "coalesce"])
@pytest.mark.parametrize("num_tasks", [2, 8])
def test_broadcast_and_coalesce_match_reference(num_tasks, coalesce):
    check_broadcast(num_tasks, (40 if coalesce else 30) + num_tasks, coalesce)


@pytest.mark.parametrize("consumers", [1, 2, 3, 8])
def test_group_coalesce_matches_reference(consumers):
    check_group_coalesce(8, consumers, 50 + consumers)


def test_group_coalesce_two_tasks_matches_reference():
    check_group_coalesce(2, 1, 59)
    check_group_coalesce(2, 2, 58)


def test_compact_with_mask_matches_reference():
    check_compact(61)


def test_data_plane_matches_reference_in_x64_mode():
    script = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from datafusion_distributed_tpu_torch import precision
        assert precision.MODE == "x64"
        from tests.test_torch_exchange import check_all
        check_all()
        print("X64-EXCHANGE-OK")
    """)
    env = dict(os.environ, DFTPU_PRECISION="x64", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "X64-EXCHANGE-OK" in proc.stdout
