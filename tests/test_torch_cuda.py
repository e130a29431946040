"""On the card: each CUDA hash-table kernel equals its plain PyTorch version
bit for bit (chip_smoke.py repeats this at main-path shapes).

This file imports neither jax nor the JAX package, so it also runs where
they are absent, as on a machine with the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from datafusion_distributed_tpu_torch.ops import hash_kernels as hk
from datafusion_distributed_tpu_torch.ops.hash import hash_columns

OPS = ("sum", "sum", "min", "max")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n=1 << 16, h=1 << 14, lanes=2, ndv=5000, seed=0,
            dtype=np.int32, live=0.9):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:  # values beyond int32: both halves of a lane vary
        vocab = rng.integers(-2**40, 2**40, (ndv, lanes))
    else:
        vocab = rng.integers(-1000, 1000, (ndv, lanes)).astype(dtype)
    keys = torch.from_numpy(vocab[rng.integers(0, ndv, n)]).to(dev)
    slot0 = (hash_columns([keys[:, i] for i in range(lanes)], [None] * lanes)
             & (h - 1)).to(torch.int32)
    live = torch.from_numpy(rng.random(n) < live).to(dev)
    return rng, keys, slot0, live, h


# name -> (_inputs arguments, max_rounds, expected overflow)
BUILD_CASES = {
    "uniform": ({}, hk.MAX_ROUNDS, False),
    "overflow": ({"ndv": 40000}, hk.MAX_ROUNDS, True),  # 40000 > 2^14 slots
    "single key": ({"ndv": 1}, hk.MAX_ROUNDS, False),
    "n below a warp": ({"n": 20, "h": 64}, hk.MAX_ROUNDS, False),
    "ragged n": ({"n": 70001}, hk.MAX_ROUNDS, False),
    "max_rounds=2": ({}, 2, True),
    "int64 lanes": ({"dtype": np.int64}, hk.MAX_ROUNDS, False),
    "one slot": ({"h": 1, "ndv": 1, "n": 300}, hk.MAX_ROUNDS, False),
    "two slots, three keys": ({"h": 2, "ndv": 3, "n": 300}, 8, True),
    "long chains": ({"h": 1 << 12, "ndv": 3500}, hk.MAX_ROUNDS, False),
    "no live row": ({"live": 0.0}, hk.MAX_ROUNDS, False),  # 0 rounds
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_group_build_matches_plain(dev, case):
    kwargs, max_rounds, over = BUILD_CASES[case]
    _rng, keys, slot0, live, h = _inputs(dev, **kwargs)
    hk.reset_launch_counts()
    got = hk.build_group_ids(keys, slot0, live, h, max_rounds)
    assert hk.LAUNCHES["build_group_ids"] == 1
    ref = hk.build_group_ids_plain(keys, slot0, live, h, max_rounds)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    assert got[4].device.type == "cuda" and got[4].shape == ()
    assert int(got[4]) == int(ref[4])
    assert bool(got[3]) == over
    if bool(got[3]):
        assert int(got[4]) == max_rounds
    assert hk.round_stats() == {"builds": 1, "total": int(got[4]),
                                "max": int(got[4])}


# name -> (_inputs arguments, max_rounds, value generator)
AGG_CASES = {
    "uniform": ({}, hk.MAX_ROUNDS, "full range"),
    "single key": ({"ndv": 1}, hk.MAX_ROUNDS, "full range"),
    "n below a warp": ({"n": 20, "h": 64}, hk.MAX_ROUNDS, "full range"),
    "ragged n": ({"n": 70001}, hk.MAX_ROUNDS, "full range"),
    "max_rounds=2": ({}, 2, "full range"),
    "one slot": ({"h": 1, "ndv": 1, "n": 300}, hk.MAX_ROUNDS, "full range"),
    "two slots, three keys": ({"h": 2, "ndv": 3, "n": 300}, 8, "full range"),
    "wrapping sums": ({"ndv": 50}, hk.MAX_ROUNDS, "near int32 max"),
    "no live row": ({"live": 0.0}, hk.MAX_ROUNDS, "full range"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(AGG_CASES))
def test_group_aggregate_matches_plain(dev, case):
    kwargs, max_rounds, values = AGG_CASES[case]
    rng, keys, slot0, live, h = _inputs(dev, **kwargs)
    n = keys.shape[0]
    if values == "near int32 max":  # every group's sums wrap mod 2^32
        vals_np = rng.integers(2**31 - 1000, 2**31 - 1, (n, 4))
    else:
        vals_np = rng.integers(-2**31, 2**31 - 1, (n, 4))
    vals = torch.from_numpy(vals_np.astype(np.int32)).to(dev)
    hk.reset_launch_counts()
    got = hk.group_aggregate(keys, slot0, live, vals, h, OPS, max_rounds)
    assert hk.LAUNCHES["group_aggregate"] == 1
    ref = hk.group_aggregate_plain(keys, slot0, live, vals, h, OPS,
                                   max_rounds)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert int(got[5]) == int(ref[5])
    assert hk.round_stats()["builds"] == 1


@pytest.mark.cuda
def test_probe_matches_plain(dev):
    _rng, keys, slot0, live, h = _inputs(dev)
    _g, tk, used, _o, _r = hk.build_group_ids(keys, slot0, live, h)
    perm = torch.randperm(keys.shape[0], device=dev)
    args = (keys[perm][:, None, :], slot0[perm][:, None], live[perm][:, None],
            tk, used, (h,))
    got = hk.multiway_probe(*args)
    ref = hk.multiway_probe_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((got[0] >= 0).any())
