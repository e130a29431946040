"""The port's native host data plane (native/: the C++ hash and CSR
buckets, built with g++ at first use) against the port's ops/hash.py and
the reference's native library, and the host regroup it serves
(runtime/coordinator.py `_shuffle_regroup_host`) against the device
regroup. Bit-exact throughout."""

import numpy as np
import pytest
import torch

from datafusion_distributed_tpu import native as jnative
from datafusion_distributed_tpu.schema import DataType as JDataType
from datafusion_distributed_tpu_torch import native
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table
from datafusion_distributed_tpu_torch.ops.hash import hash_columns
from datafusion_distributed_tpu_torch.runtime import coordinator as tcoord
from datafusion_distributed_tpu_torch.schema import DataType

torch.set_num_threads(1)


def test_hash_parity_with_the_port_hash_and_the_reference_native():
    """The C++ hash equals ops/hash.py's `hash_columns` on the same arrays
    (the active precision mode's storage widths, one column with nulls),
    and the reference's native hash."""
    rng = np.random.default_rng(0)
    n = 5000
    int_info = np.iinfo(DataType.INT64.np_dtype)
    a = rng.integers(int_info.min, int_info.max, n, dtype=np.int64).astype(
        DataType.INT64.np_dtype
    )
    b = rng.normal(size=n).astype(DataType.FLOAT64.np_dtype)
    c = rng.integers(0, 1000, n).astype(np.int32)
    d = rng.random(n) > 0.5
    valid_b = rng.random(n) > 0.1
    dev = hash_columns(
        [torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
         torch.from_numpy(d)],
        [None, torch.from_numpy(valid_b), None, None],
    ).numpy().astype(np.uint32)
    nat = native.hash_rows(
        [a, b, c, d], [None, valid_b, None, None],
        [DataType.INT64, DataType.FLOAT64, DataType.INT32, DataType.BOOL],
    )
    np.testing.assert_array_equal(dev, nat)
    ref = jnative.hash_rows(
        [a, b, c, d], [None, valid_b, None, None],
        [JDataType.INT64, JDataType.FLOAT64, JDataType.INT32,
         JDataType.BOOL],
    )
    np.testing.assert_array_equal(ref, nat)


def _numpy_reference_hash(payload_u32_lanes, valids):
    """Mode-independent numpy mirror of ops.hash.hash_columns (and the C++
    dftpu_hash_rows): murmur3 fmix32 avalanche + per-column odd multiplier."""
    def mix(h):
        h = h ^ (h >> np.uint32(16))
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h = h ^ (h >> np.uint32(13))
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
        return h ^ (h >> np.uint32(16))

    h = np.full(len(payload_u32_lanes[0]), 0x9E3779B9, dtype=np.uint32)
    for i, (lane, v) in enumerate(zip(payload_u32_lanes, valids)):
        lane = lane.astype(np.uint32)
        if v is not None:
            lane = np.where(v, lane, np.uint32(0xDEADBEEF))
        mult = np.uint32(0x01000193 + 2 * i)
        h = ((h ^ mix(lane)) * mult).astype(np.uint32)
    return mix(h)


def test_hash_64bit_branch_parity_with_numpy_reference():
    """The 64-bit fold branch (hi^lo) against a numpy mirror and the port's
    torch hash, whatever the active precision mode's storage widths."""
    rng = np.random.default_rng(2)
    n = 3000
    a = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    b = rng.normal(size=n).astype(np.float64)
    valid_b = rng.random(n) > 0.2

    u_a = a.astype(np.uint64)
    lane_a = (u_a ^ (u_a >> np.uint64(32))).astype(np.uint32)
    u_b = b.view(np.uint64)
    lane_b = (u_b ^ (u_b >> np.uint64(32))).astype(np.uint32)
    exp = _numpy_reference_hash([lane_a, lane_b], [None, valid_b])

    nat = native.hash_rows(
        [a, b], [None, valid_b], [DataType.INT64, DataType.FLOAT64]
    )
    np.testing.assert_array_equal(nat, exp)
    dev = hash_columns([torch.from_numpy(a), torch.from_numpy(b)],
                       [None, torch.from_numpy(valid_b)]).numpy()
    np.testing.assert_array_equal(dev.astype(np.uint32), exp)


def test_shuffle_buckets_csr():
    rng = np.random.default_rng(1)
    n = 10_000
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    live = rng.random(n) > 0.05
    parts = 8
    offsets, indices, counts = native.shuffle_buckets(h, live, parts)
    assert offsets[0] == 0 and offsets[-1] == counts.sum() == live.sum()
    # every live row appears exactly once, in its hash bucket, in order
    seen = np.zeros(n, dtype=bool)
    for p in range(parts):
        rows = indices[offsets[p]: offsets[p + 1]]
        assert not seen[rows].any()
        assert np.all(np.diff(rows) > 0)
        seen[rows] = True
        np.testing.assert_array_equal(h[rows] % parts, p)
    assert seen.sum() == live.sum()
    assert not seen[~live].any()
    ref = jnative.shuffle_buckets(h, live, parts)
    for got, exp in zip((offsets, indices, counts), ref):
        np.testing.assert_array_equal(got, exp)


def test_bucket_counts_match_numpy():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    offsets, indices, counts = native.shuffle_buckets(h, None, 5)
    exp = np.bincount(h % 5, minlength=5)
    np.testing.assert_array_equal(counts, exp)


def _producers(seed: int):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((700, 0, 1300)):
        k = rng.integers(0, 90, n)
        arrow = pa.table({
            "k": pa.array(k, mask=rng.random(n) < 0.1),
            "s": pa.array(rng.choice(["a", "b", "c"], n)),
            "v": rng.normal(size=n),
        })
        out.append(arrow_to_table(arrow, capacity=2048, device="cpu"))
    return out


@pytest.mark.parametrize("exact", [False, True], ids=["padded", "exact"])
@pytest.mark.parametrize("zero_copy", [True, False],
                         ids=["views", "copying"])
def test_host_regroup_equals_the_device_regroup(zero_copy, exact):
    """Producer tables in host memory take the native regroup; it gives
    every destination the rows, row order and capacity of the device
    regroup of the same tables."""
    outs = _producers(7)
    host = tcoord._shuffle_regroup(outs, ["k", "s"], 4, 2048,
                                   zero_copy=zero_copy, exact=exact)
    if zero_copy:
        dev = tcoord._shuffle_regroup_views(outs, ["k", "s"], 4, 2048,
                                            exact)
    else:
        # the device copying path, as the coordinator took it before
        # host tables had their own regroup
        dev = []
        for j in range(4):
            parts = []
            for out in outs:
                dest = hash_columns(
                    [out.column(k).data for k in ("k", "s")],
                    [out.column(k).validity for k in ("k", "s")]) % 4
                parts.append(out.compact(out.row_mask() & (dest == j)))
            dev.append(tcoord.concat_tables(parts, capacity=3 * 2048))
    assert sum(int(t.num_rows) for t in host) == 2000
    for a, b in zip(host, dev):
        assert a.capacity == b.capacity
        na, nb = a.to_numpy(), b.to_numpy()
        assert list(na) == list(nb)
        for col in na:
            np.testing.assert_array_equal(np.ma.getdata(na[col]),
                                          np.ma.getdata(nb[col]),
                                          err_msg=col)
            np.testing.assert_array_equal(np.ma.getmaskarray(na[col]),
                                          np.ma.getmaskarray(nb[col]),
                                          err_msg=col)
