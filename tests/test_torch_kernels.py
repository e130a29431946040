"""The plain PyTorch versions of the port's three hash-table kernels
(datafusion_distributed_tpu_torch/ops/hash_kernels.py), held against the
reference package:

- the XLA claim loop / probe loop (`build_group_table`, `probe_group_table`):
  exact gid, slot keys, used slots, found slots and overflow verdicts;
- the Pallas kernels in interpret mode (as tests/test_pallas_hash.py runs
  them): the same grouping, the same set of used-slot keys, and per group
  the same accumulators and representative row — their slot layout differs
  by design;
- `multiway_probe_reference` at K = 3.

The CUDA kernels themselves are compared with these plain versions on the
card (tests/test_torch_cuda.py, and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datafusion_distributed_tpu.ops import aggregate as jagg
from datafusion_distributed_tpu.ops import join as jjoin
from datafusion_distributed_tpu.ops import pallas_hash as jph
from datafusion_distributed_tpu_torch.ops import aggregate as tagg
from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
from datafusion_distributed_tpu_torch.ops import join as tjoin
from datafusion_distributed_tpu_torch.ops.hash import hash_columns
from tests.torch_port_helpers import np_of

torch.set_num_threads(1)


def _key_columns(rng, n, ncols, ndv, with_nulls):
    vocab = rng.integers(-1000, 1000, (ndv, ncols)).astype(np.int32)
    keys = vocab[rng.integers(0, ndv, n)]
    cols = [keys[:, i] for i in range(ncols)]
    if ncols >= 2:  # one float key column, with signed zeros
        f = cols[1].astype(np.float32) / 4
        f[f == 0] = np.where(rng.random((f == 0).sum()) < 0.5, 0.0, -0.0)
        cols[1] = f
    valids = [
        (rng.random(n) < 0.85) if with_nulls and i == 0 else None
        for i in range(ncols)
    ]
    return cols, valids


def _both(cols, valids):
    j = ([jnp.asarray(c) for c in cols],
         [None if v is None else jnp.asarray(v) for v in valids])
    t = ([torch.from_numpy(c) for c in cols],
         [None if v is None else torch.from_numpy(v) for v in valids])
    return j, t


BUILD_CASES = [
    # n, key columns, slots, ndv, nulls
    (300, 1, 64, 20, False),
    (1000, 2, 256, 100, True),
    (2048, 3, 1024, 400, True),
    (500, 1, 64, 200, False),  # more distinct keys than slots: overflow
    (4000, 2, 128, 60, False),  # 47% load, long chains
]


@pytest.mark.parametrize("n,ncols,h,ndv,nulls", BUILD_CASES)
def test_build_matches_reference_claim_loop(n, ncols, h, ndv, nulls):
    rng = np.random.default_rng(n + h)
    cols, valids = _key_columns(rng, n, ncols, ndv, nulls)
    live = rng.random(n) < 0.9
    (jc, jv), (tc, tv) = _both(cols, valids)
    ref = jagg.build_group_table(jc, jv, jnp.asarray(live), h)
    got = tagg.build_group_table(tc, tv, torch.from_numpy(live), h)
    np.testing.assert_array_equal(np_of(got.group_ids), np_of(ref.group_ids))
    np.testing.assert_array_equal(np_of(got.slot_used), np_of(ref.slot_used))
    for a, b in zip(got.slot_keys, ref.slot_keys):
        np.testing.assert_array_equal(np_of(a).view(np.int32),
                                      np_of(b).view(np.int32))
    for a, b in zip(got.slot_key_valid, ref.slot_key_valid):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np_of(a), np_of(b))
    assert bool(got.overflow) == bool(ref.overflow)
    assert int(got.num_groups) == int(ref.num_groups)
    if ndv > h:
        assert bool(got.overflow)


def test_build_forced_overflow_by_round_cap():
    """Long chains with a small round cap: the overflow verdict and the
    partial table both equal the reference's."""
    rng = np.random.default_rng(3)
    cols, valids = _key_columns(rng, 2000, 1, 900, False)
    live = np.ones(2000, bool)
    (jc, jv), (tc, tv) = _both(cols, valids)
    ref = jagg.build_group_table(jc, jv, jnp.asarray(live), 1024, max_rounds=3)
    got = tagg.build_group_table(tc, tv, torch.from_numpy(live), 1024,
                                 max_rounds=3)
    assert bool(ref.overflow) and bool(got.overflow)
    np.testing.assert_array_equal(np_of(got.group_ids), np_of(ref.group_ids))
    np.testing.assert_array_equal(np_of(got.slot_used), np_of(ref.slot_used))


@pytest.mark.parametrize("max_rounds", [512, 2])
@pytest.mark.parametrize("nulls", [False, True])
def test_probe_matches_reference_probe_loop(max_rounds, nulls):
    rng = np.random.default_rng(11 + max_rounds + nulls)
    nb, npr, h = 600, 900, 1024
    bcols, bvalids = _key_columns(rng, nb, 2, 300, nulls)
    # probe keys are build rows; half of them shifted out of the vocabulary
    pick = rng.integers(0, nb, npr)
    pcols = [c[pick] for c in bcols]
    pcols[0] = np.where(rng.random(npr) < 0.5, pcols[0], pcols[0] + 5000)
    pvalids = [None if v is None else rng.random(npr) < 0.85 for v in bvalids]
    blive = np.ones(nb, bool)
    plive = rng.random(npr) < 0.9
    lane_plan = [v is not None for v in bvalids]
    (jbc, jbv), (tbc, tbv) = _both(bcols, bvalids)
    (jpc, jpv), (tpc, tpv) = _both(pcols, pvalids)
    jgt = jagg.build_group_table(jbc, jbv, jnp.asarray(blive), h,
                                 lane_plan=lane_plan)
    tgt = tagg.build_group_table(tbc, tbv, torch.from_numpy(blive), h,
                                 lane_plan=lane_plan)
    jraw = jjoin._raw_slot_keys(jgt, jbc, lane_plan)
    traw = tjoin._raw_slot_keys(tgt, lane_plan)
    np.testing.assert_array_equal(np_of(traw), np_of(jraw))
    jf, jo = jjoin.probe_group_table(jraw, jgt.slot_used, jpc, jpv,
                                     jnp.asarray(plive), lane_plan,
                                     max_rounds=max_rounds)
    tf, to = tjoin.probe_group_table(traw, tgt.slot_used, tpc, tpv,
                                     torch.from_numpy(plive), lane_plan,
                                     max_rounds=max_rounds)
    np.testing.assert_array_equal(np_of(tf), np_of(jf))
    assert bool(to) == bool(jo)
    assert (np_of(tf) >= 0).any()


# ---------------------------------------------------------------------------
# against the Pallas kernels (interpret mode) and their numpy oracles
# ---------------------------------------------------------------------------


def _lane_keys(rng, n, lanes, ndv):
    vocab = rng.integers(-1000, 1000, (ndv, lanes)).astype(np.int32)
    return vocab[rng.integers(0, ndv, n)]


def _slot0(keys, h):
    t = torch.from_numpy(keys)
    return (hash_columns([t[:, i] for i in range(keys.shape[1])],
                         [None] * keys.shape[1]) & (h - 1)).to(torch.int32)


def _assert_same_grouping(gid_a, gid_b, live):
    """Rows group together under one layout iff they do under the other."""
    a, b = gid_a[live], gid_b[live]
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    assert len(np.unique(pairs[:, 0])) == len(pairs)
    assert len(np.unique(pairs[:, 1])) == len(pairs)


@pytest.mark.parametrize("n,lanes,h,ndv",
                         [(512, 2, 128, 50), (1000, 3, 256, 100)])
def test_build_matches_pallas_grouping(n, lanes, h, ndv):
    rng = np.random.default_rng(n)
    keys = _lane_keys(rng, n, lanes, ndv)
    live = rng.random(n) > 0.1
    slot0 = _slot0(keys, h)
    pg, ptk, pused, pover = jph.pallas_build_group_ids(
        jnp.asarray(keys), jnp.asarray(np_of(slot0)), jnp.asarray(live), h,
        interpret=True,
    )
    gid, tk, used, over, _rounds = hk.build_group_ids(
        torch.from_numpy(keys), slot0, torch.from_numpy(live), h)
    assert bool(over) == bool(pover) is False
    _assert_same_grouping(np_of(gid), np_of(pg), live)
    ours = {tuple(r) for r in np_of(tk)[np_of(used)]}
    theirs = {tuple(r) for r in np.asarray(ptk)[np.asarray(pused)]}
    assert ours == theirs


OPS = ("sum", "sum", "min", "max")


@pytest.mark.parametrize("n,lanes,h,ndv",
                         [(600, 1, 128, 40), (900, 2, 256, 120)])
def test_group_aggregate_matches_pallas(n, lanes, h, ndv):
    rng = np.random.default_rng(n + lanes)
    keys = _lane_keys(rng, n, lanes, ndv)
    live = rng.random(n) > 0.15
    vals = np.stack([
        np.ones(n), rng.integers(-50, 50, n),
        rng.integers(-2**31, 2**31 - 1, n), rng.integers(-2**31, 2**31 - 1, n),
    ], axis=1).astype(np.int32)
    slot0 = _slot0(keys, h)
    pg, prep, pused, pacc, pover = jph.pallas_global_hash_aggregate(
        jnp.asarray(keys), jnp.asarray(np_of(slot0)), jnp.asarray(live),
        jnp.asarray(vals), h, OPS, interpret=True,
    )
    gid, rep, used, acc, over, _r = hk.group_aggregate(
        torch.from_numpy(keys), slot0, torch.from_numpy(live),
        torch.from_numpy(vals), h, OPS)
    assert bool(over) == bool(pover) is False
    gid, pg = np_of(gid), np.asarray(pg)
    _assert_same_grouping(gid, pg, live)
    # per live row: its group's accumulators and representative agree
    np.testing.assert_array_equal(np_of(acc)[gid[live]],
                                  np.asarray(pacc)[pg[live]])
    np.testing.assert_array_equal(np_of(rep)[gid[live]],
                                  np.asarray(prep)[pg[live]])
    assert np_of(used).sum() == np.asarray(pused).sum()
    # unused slots: identities and rep 0, as in the Pallas kernel
    unused = ~np_of(used)
    assert (np_of(rep)[unused] == 0).all()
    idents = np.array([hk.AGG_OPS[o][1] for o in OPS], np.int32)
    assert (np_of(acc)[unused] == idents).all()


def test_group_aggregate_matches_numpy_oracle_accumulators():
    """rep / acc against global_hash_aggregate_reference per group."""
    rng = np.random.default_rng(9)
    n, h = 700, 256
    keys = _lane_keys(rng, n, 2, 90)
    live = rng.random(n) > 0.2
    vals = np.stack([
        np.ones(n), rng.integers(-50, 50, n),
        rng.integers(-2**31, 2**31 - 1, n), rng.integers(-2**31, 2**31 - 1, n),
    ], axis=1).astype(np.int32)
    slot0 = _slot0(keys, h)
    og, orep, oused, oacc, oover = jph.global_hash_aggregate_reference(
        keys, np_of(slot0), live, vals, h, OPS)
    gid, rep, used, acc, over, _r = hk.group_aggregate(
        torch.from_numpy(keys), slot0, torch.from_numpy(live),
        torch.from_numpy(vals), h, OPS)
    assert not bool(over) and not oover
    gid = np_of(gid)
    _assert_same_grouping(gid, og, live)
    np.testing.assert_array_equal(np_of(acc)[gid[live]], oacc[og[live]])
    np.testing.assert_array_equal(np_of(rep)[gid[live]], orep[og[live]])


def test_group_aggregate_build_equals_group_build():
    """Kernel 3's gid / used are kernel 1's exactly (same claim-loop
    layout), so the fused GROUP BY keeps the unfused output order."""
    rng = np.random.default_rng(4)
    n, h = 1500, 512
    keys = torch.from_numpy(_lane_keys(rng, n, 2, 200))
    live = torch.from_numpy(rng.random(n) > 0.1)
    slot0 = _slot0(keys.numpy(), h)
    vals = torch.ones((n, 1), dtype=torch.int32)
    g1, _tk, u1, o1, r1 = hk.build_group_ids(keys, slot0, live, h)
    g3, rep, u3, acc, o3, r3 = hk.group_aggregate(keys, slot0, live, vals, h,
                                                  ("sum",))
    assert torch.equal(g1, g3) and torch.equal(u1, u3) and r1 == r3
    assert bool(o1) == bool(o3)
    counts = torch.bincount(g1[live].long(), minlength=h).to(torch.int32)
    assert torch.equal(acc[:, 0], counts)


def test_round_stats_stay_bounded_aggregates():
    """Every build adds to one fixed counter per device (builds, summed
    rounds, the most rounds), however many builds a session makes; rounds
    come back as 0-d tensors, and the plain versions do not count as
    launches."""
    rng = np.random.default_rng(6)
    n, h = 600, 256
    keys = torch.from_numpy(_lane_keys(rng, n, 1, 100))
    live = torch.ones(n, dtype=torch.bool)
    slot0 = _slot0(keys.numpy(), h)
    vals = torch.ones((n, 1), dtype=torch.int32)
    hk.reset_launch_counts()
    r1 = hk.build_group_ids(keys, slot0, live, h)[4]
    r3 = hk.group_aggregate(keys, slot0, live, vals, h, ("sum",))[5]
    assert r1.shape == () and r3.shape == ()
    r1, r3 = int(r1), int(r3)
    for _ in range(50):
        hk.build_group_ids(keys, slot0, live, h)
    assert hk.round_stats() == {"builds": 52, "total": r1 + r3 + 50 * r1,
                                "max": max(r1, r3)}
    assert list(hk.ROUND_STATS) == [torch.device("cpu")]
    assert hk.ROUND_STATS[torch.device("cpu")].shape == (3,)
    assert set(hk.launches().values()) == {0}
    hk.reset_round_stats()
    assert hk.round_stats() == {"builds": 0, "total": 0, "max": 0}


@pytest.mark.parametrize("max_rounds", [512, 3])
def test_multiway_probe_matches_reference_k3(max_rounds):
    rng = np.random.default_rng(21 + max_rounds)
    lanes, n = 2, 800
    table_slots = (256, 64, 128)
    tparts, uparts, kparts, sparts = [], [], [], []
    for hk_slots, ndv in zip(table_slots, (100, 40, 50)):
        bkeys = _lane_keys(rng, ndv * 2, lanes, ndv)
        s0 = _slot0(bkeys, hk_slots)
        _g, tk, used, over, _r = hk.build_group_ids(
            torch.from_numpy(bkeys), s0, torch.ones(len(bkeys), dtype=torch.bool),
            hk_slots)
        assert not bool(over)
        tparts.append(np_of(tk))
        uparts.append(np_of(used))
        pk = np.where(rng.random((n, 1)) < 0.6,
                      bkeys[rng.integers(0, len(bkeys), n)],
                      _lane_keys(rng, n, lanes, 500) + 3000)
        kparts.append(pk)
        sparts.append(np_of(_slot0(pk, hk_slots)))
    keys = np.stack(kparts, axis=1)
    slot0 = np.stack(sparts, axis=1)
    active = rng.random((n, 3)) < 0.9
    tkeys = np.concatenate(tparts)
    used = np.concatenate(uparts)
    ref_found, ref_over = jph.multiway_probe_reference(
        keys, slot0, active, tkeys, used, table_slots) if max_rounds == 512 \
        else (None, None)
    found, over = hk.multiway_probe(
        torch.from_numpy(keys), torch.from_numpy(slot0),
        torch.from_numpy(active), torch.from_numpy(tkeys),
        torch.from_numpy(used), table_slots, max_rounds)
    if ref_found is not None:
        np.testing.assert_array_equal(np_of(found), ref_found)
        np.testing.assert_array_equal(np_of(over), ref_over)
        assert (ref_found >= 0).any() and (ref_found < 0).any()
    else:
        # a 3-step cap leaves long chains unresolved: flagged per table,
        # and whatever resolved agrees with the uncapped probe
        full, _ = hk.multiway_probe(
            torch.from_numpy(keys), torch.from_numpy(slot0),
            torch.from_numpy(active), torch.from_numpy(tkeys),
            torch.from_numpy(used), table_slots)
        hit = np_of(found) >= 0
        np.testing.assert_array_equal(np_of(found)[hit], np_of(full)[hit])
        assert np_of(over).any()


SMEM_H100 = 232_448 - 16  # a block's dynamic shared memory, less the barrier


@pytest.mark.parametrize("slots,lanes,route", [
    (1 << 15, 1, "smem"),  # supplier at SF 1: 160 KB of keys and flags
    (64, 1, "smem"),  # nation
    (16, 2, "smem"),  # region, key and validity lane
    (1, 1, "smem"),
    (1 << 15, 2, "l2"),  # 288 KB
    (1 << 19, 1, "l2"),  # customer, part
    (1 << 21, 1, "l2"),  # orders, partsupp
])
def test_probe_route_by_table_bytes(slots, lanes, route):
    assert hk.probe_route(slots, lanes, SMEM_H100) == route
    need = hk.smem_table_bytes(slots, lanes)
    assert hk.probe_route(slots, lanes, need) == "smem"
    assert hk.probe_route(slots, lanes, need - 1) == "l2"


@pytest.mark.parametrize("nbytes", [1, 4, 15, 16, 17, 4 * 3 * 1000, 1 << 17])
def test_smem_table_bytes_cover_the_bulk_copies(nbytes):
    """The shared-memory route copies each span widened to 16-byte
    boundaries (csrc/probe.cu); whatever the span's start, the widened
    copy fits what smem_table_bytes reserves for it."""
    def reserved(span):
        return -(-span // 16) * 16 + 16

    widest = max((start + nbytes + 15) // 16 * 16 - start // 16 * 16
                 for start in range(64))
    assert widest <= reserved(nbytes)
    for slots, lanes in ((1000, 3), (nbytes, 1)):
        assert hk.smem_table_bytes(slots, lanes) == (
            reserved(4 * lanes * slots) + reserved(slots))


def test_probe_launches_pack_descriptors_per_group():
    """Table descriptors (first slot in the packed arrays, slot count) go
    by value, at most ``cap`` tables a launch: more tables take one launch
    per consecutive group, each group routed by its own bytes."""
    table_slots = (1 << 13,) * 8 + (1 << 10,) * 2
    launches = hk.probe_launches(table_slots, 1, SMEM_H100)
    assert hk.MAX_TABLES_PER_LAUNCH == 8
    assert [(la.k0, la.route) for la in launches] == [(0, "l2"), (8, "smem")]
    assert launches[0].slots == (1 << 13,) * 8
    assert launches[0].offsets == tuple(k << 13 for k in range(8))
    assert launches[1].offsets == (8 << 13, (8 << 13) + 1024)
    assert launches[1].slots == (1024, 1024)
    # any cap: the groups cover the tables in order, offsets are prefix sums
    slots = (4, 64, 1 << 20, 2, 8, 1 << 12, 16)
    for cap in (1, 2, 3, 7, 8):
        groups = hk.probe_launches(slots, 2, SMEM_H100, cap)
        assert len(groups) == -(-len(slots) // cap)
        assert [la.k0 for la in groups] == list(range(0, len(slots), cap))
        assert sum((la.slots for la in groups), ()) == slots
        assert sum((la.offsets for la in groups), ()) == tuple(
            int(v) for v in np.cumsum((0,) + slots[:-1]))
        for la in groups:
            assert la.route == hk.probe_route(sum(la.slots), 2, SMEM_H100)
    one = hk.probe_launches((1 << 21,), 1, SMEM_H100)
    assert one == (hk.ProbeLaunch(0, (0,), (1 << 21,), "l2"),)


@pytest.mark.parametrize("pairs,slots,lanes,packs", [
    (8_388_608, 1 << 19, 1, True),  # lineitem against customer or part
    (8_388_608, 1 << 19, 3, True),
    (8_388_608, 1 << 19, 4, False),  # a record holds at most 3 lanes
    (8_388_608, 1 << 21, 2, False),  # lineitem against orders: too few
    (262_144, 1 << 19, 2, False),
])
def test_packs_records_for_probes_large_beside_their_tables(pairs, slots,
                                                            lanes, packs):
    assert hk.packs_records(pairs, slots, lanes) == packs
    assert hk.packs_records(hk.PACK_PAIRS_PER_SLOT * slots, slots, 1)
    assert not hk.packs_records(hk.PACK_PAIRS_PER_SLOT * slots - 1, slots, 1)


def test_probe_on_the_cpu_runs_the_plain_version_only():
    """A CPU tensor takes the plain version: no launch, no probe shape."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(_lane_keys(rng, 50, 1, 10))
    table = torch.from_numpy(_lane_keys(rng, 16, 1, 16))
    args = (keys[:, None, :], _slot0(keys.numpy(), 16)[:, None],
            torch.ones((50, 1), dtype=torch.bool), table,
            torch.ones(16, dtype=torch.bool), (16,))
    hk.reset_launch_counts()
    found, over = hk.multiway_probe(*args)
    ref = hk.multiway_probe_plain(*args)
    assert torch.equal(found, ref[0]) and torch.equal(over, ref[1])
    assert hk.launches()["multiway_probe"] == 0 and hk.PROBE_SHAPES == {}


def test_build_on_the_cpu_runs_the_plain_version_only():
    """A CPU tensor takes the plain version: no launch, no build shape."""
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(_lane_keys(rng, 50, 2, 10))
    args = (keys, _slot0(keys.numpy(), 16), torch.ones(50, dtype=torch.bool),
            16)
    hk.reset_launch_counts()
    got = hk.build_group_ids(*args)
    ref = hk.build_group_ids_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert hk.launches()["build_group_ids"] == 0 and hk.BUILD_SHAPES == {}


@pytest.mark.parametrize("live_fraction", [0.0, 0.9])
def test_build_reports_rounds_and_overflow_as_tensors(live_fraction):
    """rounds and overflow are 0-d tensors (on the card they stay there);
    a build with no live row takes no round, as the reference's loop."""
    rng = np.random.default_rng(8)
    n, h = 400, 128
    keys = torch.from_numpy(_lane_keys(rng, n, 2, 40))
    live = torch.from_numpy(rng.random(n) < live_fraction)
    slot0 = _slot0(keys.numpy(), h)
    vals = torch.ones((n, 1), dtype=torch.int32)
    _g, _tk, _u, over, rounds = hk.build_group_ids(keys, slot0, live, h)
    out3 = hk.group_aggregate(keys, slot0, live, vals, h, ("sum",))
    for t, dtype in ((over, torch.bool), (rounds, torch.int32),
                     (out3[4], torch.bool), (out3[5], torch.int32)):
        assert t.shape == () and t.dtype == dtype
    assert not bool(over) and not bool(out3[4])
    assert int(rounds) == int(out3[5])
    assert (int(rounds) == 0) == (live_fraction == 0.0)
    if live_fraction == 0.0:
        assert not bool(out3[2].any()) and not bool(out3[1].any())


def test_wrappers_validate_arguments():
    keys = torch.zeros((4, 1), dtype=torch.int32)
    s0 = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        hk.build_group_ids(keys, s0, live, 6)  # not a power of two
    with pytest.raises(ValueError):
        hk.build_group_ids(keys, s0, live, 8, max_rounds=0)
    with pytest.raises(ValueError):
        hk.group_aggregate(keys, s0, live,
                           torch.zeros((4, 33), dtype=torch.int32), 8,
                           ("sum",) * 33)  # more than MAX_ACCS
    with pytest.raises(TypeError):
        hk.build_group_ids(keys.float(), s0, live, 8)
    with pytest.raises(ValueError):
        hk.group_aggregate(keys, s0, live, torch.zeros((4, 1), dtype=torch.int32),
                           8, ("avg",))
