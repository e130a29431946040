"""Kernel 4's plain version, and its wrapper on CPU tensors, against the
library scatters the GROUP BYs called before it (``index_add_`` over the
drop slot, ``scatter_reduce_``), against the JAX package's segment sums
(``zeros(H).at[gid].add(vals, mode="drop")``, its ``seg_sum``) and its
GROUP BY-less aggregate over a live prefix; and `SegmentSum`'s float sums,
which must keep their bits now that their segment lengths come from the
fold. The kernel itself is held against the plain version on the card in
`tests/test_torch_cuda.py`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datafusion_distributed_tpu.ops import aggregate as jagg
from datafusion_distributed_tpu.ops.table import Table as JTable
from datafusion_distributed_tpu.schema import DataType as JDT
from datafusion_distributed_tpu.schema import Field as JField
from datafusion_distributed_tpu.schema import Schema as JSchema
from datafusion_distributed_tpu_torch.ops import aggregate as tagg
from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
from tests.torch_port_helpers import assert_results_equal, port_table

torch.set_num_threads(1)

N = 3000
DTYPES = [torch.bool, torch.int8, torch.int16, torch.int32, torch.int64]
SLOTS = [1, 8, 1 << 12]
#: live prefixes: None (no bound), then 0, 1, part of and all of N rows
PREFIXES = [None, 0, 1, 1234, N]


def _values(rng, dtype, n):
    """Values spanning the dtype, its extremes included; int64 values near
    +-2^62, so that their sums wrap."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    info = torch.iinfo(dtype)
    if dtype == torch.int64:
        v = rng.integers(-2**62, 2**62, n, dtype=np.int64) * 2
    else:
        v = rng.integers(info.min, info.max, n, endpoint=True)
    v[:4] = [info.min, info.max, info.min, info.max]
    return torch.from_numpy(v).to(dtype)


def _case(dtype, num_slots, prefix):
    """(gid with nulls and the drop slot at random positions, values, the
    live prefix as a 0-d tensor or None, the ids the old callers passed:
    every row past the prefix moved to the drop slot)."""
    rng = np.random.default_rng(num_slots * 7 + DTYPES.index(dtype))
    gid = rng.integers(0, num_slots + 1, N)
    gid[rng.random(N) < 0.15] = num_slots  # nulls drop out
    vals = _values(rng, dtype, N)
    gid = torch.from_numpy(gid).to(torch.int32)
    num_rows = None if prefix is None else torch.tensor(prefix,
                                                        dtype=torch.int32)
    live = torch.arange(N) < (N if prefix is None else prefix)
    return gid, vals, num_rows, torch.where(live, gid, num_slots).long()


def _old_sum(old_gid, vals, num_slots):
    z = torch.zeros(num_slots + 1, dtype=vals.dtype)
    return z.index_add_(0, old_gid, vals)[:num_slots]


def _old_minmax(old_gid, vals, num_slots, op):
    """segment_minmax as it was (bool widened: the CPU scatter takes no
    bool min/max)."""
    wide = torch.int32 if vals.dtype == torch.bool else vals.dtype
    init = tagg._dtype_max(vals.dtype) if op == "min" else tagg._dtype_min(
        vals.dtype)
    z = torch.full((num_slots + 1,), int(init), dtype=wide)
    z.scatter_reduce_(0, old_gid, vals.to(wide),
                      reduce="amin" if op == "min" else "amax")
    return z[:num_slots].to(vals.dtype)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_fold_matches_library_scatters(dtype, num_slots, prefix):
    """Every op, plain and through the wrapper, equals the old call on the
    ids the callers built: dead rows past the prefix and null rows in the
    drop slot, which the fold skips itself. Sums wrap in their dtype; empty
    slots hold the dtype's identity."""
    gid, vals, num_rows, old_gid = _case(dtype, num_slots, prefix)
    want = {"min": _old_minmax(old_gid, vals, num_slots, "min"),
            "max": _old_minmax(old_gid, vals, num_slots, "max"),
            "count": _old_sum(old_gid, torch.ones(N, dtype=torch.int64),
                              num_slots)}
    if dtype != torch.bool:
        want["sum"] = _old_sum(old_gid, vals, num_slots)
    else:  # a bool mask counted: the COUNTs' valid.to(int)
        want["sum"] = _old_sum(old_gid, vals.to(torch.int32), num_slots)
        vals = vals.to(torch.int32)
    for op, w in want.items():
        v = None if op == "count" else vals
        if op in ("min", "max") and dtype == torch.bool:
            v = vals.to(torch.bool)
        # int64 ids fold the same as int32 ones
        for fold, ids in ((hk.group_fold_plain, gid), (hk.group_fold, gid),
                          (hk.group_fold, gid.long())):
            got = fold(ids, v, num_slots, op, num_rows)
            assert got.dtype == w.dtype and got.shape == (num_slots,), op
            assert torch.equal(got, w), (fold.__name__, ids.dtype, op)


def test_group_fold_int64_sums_wrap():
    """Sums past 2^63 wrap in two's complement, as index_add_'s do."""
    big = torch.full((64,), 2**62, dtype=torch.int64)
    gid = torch.zeros(64, dtype=torch.int64)
    for n, want in ((64, 0), (3, 3 * 2**62 - 2**64), (2, -2**63)):
        got = hk.group_fold(gid[:n], big[:n], 1, "sum")
        assert int(got[0]) == want
        assert torch.equal(got, _old_sum(gid[:n], big[:n], 1))


@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_group_fold_sums_match_jax_segment_sum(dtype, num_slots):
    """The JAX package's segment sum over the same ids (nulls and dead rows
    in the drop slot, which ``mode="drop"`` discards), wrapping in the
    values' dtype; 64-bit sums need the reference's x64 mode, which this
    process does not run."""
    for prefix in PREFIXES:
        gid, vals, num_rows, old_gid = _case(dtype, num_slots, prefix)
        ref = jnp.zeros(num_slots, dtype=jnp.dtype(str(vals.dtype)[6:])) \
            .at[jnp.asarray(old_gid.numpy())].add(jnp.asarray(vals.numpy()),
                                                  mode="drop")
        got = hk.group_fold(gid, vals, num_slots, "sum", num_rows)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jtable(rng, cap, num_rows):
    """A reference table of ``cap`` rows, ``num_rows`` of them live: a
    nullable int32 column with its extremes and a date column."""
    data = {"i": rng.integers(-2**31, 2**31 - 1, cap, endpoint=True)
            .astype(np.int32),
            "d": rng.integers(0, 40, cap).astype(np.int32)}
    data["i"][:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    schema = JSchema([JField("i", JDT.INT32, True),
                      JField("d", JDT.DATE32, False)])
    jt = JTable.from_numpy(data, schema, capacity=cap,
                           validity={"i": rng.random(cap) < 0.8})
    return dataclasses.replace(jt, num_rows=jnp.asarray(num_rows, jnp.int32))


@pytest.mark.parametrize("prefix", [0, 1, 77, 256])
def test_global_aggregate_live_prefix_matches_reference(prefix):
    """A GROUP BY-less aggregate skips the rows past its live prefix (the
    fold's bound) and gives the JAX package's answers: COUNT(*), COUNT,
    SUM (wrapping in int32 storage), MIN and MAX at int32's extremes."""
    jt = _jtable(np.random.default_rng(prefix), 256, prefix)
    tt = port_table(jt)
    specs = [("count_star", None, "n"), ("count", "i", "c"),
             ("sum", "i", "s"), ("min", "i", "lo"), ("max", "i", "hi"),
             ("min", "d", "dlo"), ("max", "d", "dhi")]
    a = jagg.global_aggregate(jt, [jagg.AggSpec(*s) for s in specs])
    b = tagg.global_aggregate(tt, [tagg.AggSpec(*s) for s in specs])
    assert_results_equal(a.to_numpy(), b.to_numpy(), f"prefix {prefix}")


def _old_float_sum(gid, vals, num_slots):
    """SegmentSum's float path as it was: int64 ids, segment lengths from
    index_add_ over all num_slots + 1 segments."""
    gid = gid.to(torch.int64)
    order = torch.argsort(gid, stable=True)
    lengths = torch.zeros(num_slots + 1, dtype=torch.int64).index_add_(
        0, gid, torch.ones_like(gid))
    return torch.segment_reduce(vals[order], "sum", lengths=lengths,
                                unsafe=True, initial=0)[:num_slots]


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("num_slots", [8, 1 << 12])
def test_segment_sum_float_bits_unchanged(num_slots, prefix):
    """Float sums keep their bits: their lengths span the whole capacity,
    the drop slot's being the capacity less the other slots', whatever the
    live prefix (a GROUP BY-less aggregate's dead rows stay in slot 0)."""
    rng = np.random.default_rng(num_slots + (prefix or 0))
    for gid_np in (rng.integers(0, num_slots + 1, N), np.zeros(N, np.int64)):
        gid = torch.from_numpy(gid_np).to(torch.int32)
        vals = torch.from_numpy(rng.normal(0, 1e6, N))
        num_rows = None if prefix is None else torch.tensor(prefix)
        seg = tagg.SegmentSum(gid, num_slots, num_rows)
        want = _old_float_sum(gid, vals, num_slots)
        got = seg(vals)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
        assert int(seg._lengths.sum()) == N
