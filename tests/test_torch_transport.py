"""The port's wire framing (runtime/transport.py) against the reference's.

- a frame packed by either package unpacks in the other to the same header
  and blobs, and the same input packs to byte-identical frames, for every
  codec (zstd at level 1, none, lz4 where installed) and for mixed
  per-blob codecs;
- codec negotiation and the lz4 gate give the reference's answers;
- chunked iteration and reassembly, the connection budget;
- the port's wire accounting counts what crossed.
"""

import numpy as np
import pyarrow as pa
import pytest

from datafusion_distributed_tpu.io.parquet import arrow_to_table as j_arrow
from datafusion_distributed_tpu.runtime import codec as jcodec
from datafusion_distributed_tpu.runtime import transport as jt
from datafusion_distributed_tpu_torch.io.parquet import arrow_to_table as t_arrow
from datafusion_distributed_tpu_torch.runtime import codec as tcodec
from datafusion_distributed_tpu_torch.runtime import transport as tt

PACKAGES = {"jax": jt, "torch": tt}


def _blobs(seed: int) -> dict:
    """An Arrow IPC payload of a seeded table (compressible), raw random
    bytes (not compressible: ships raw) and an empty blob."""
    rng = np.random.default_rng(seed)
    arrow = pa.table({
        "k": rng.integers(0, 50, 3000),
        "v": rng.normal(size=3000),
        "s": pa.array(rng.choice(["aa", "bb", "cc"], 3000)),
    })
    return {
        "table": bytes(tcodec.encode_table(t_arrow(arrow, device="cpu"))),
        "noise": rng.bytes(2048),
        "empty": b"",
    }


CODECS = ["zstd", "none", "lz4"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_frames_cross_both_ways(direction, codec):
    src, dst = direction.split("->")
    blobs = _blobs(1)
    header = {"part": 3, "progress": {"rows_out": 7}}
    frame = PACKAGES[src].pack_frame(header, blobs, codec=codec)
    assert frame == PACKAGES[dst].pack_frame(header, blobs, codec=codec)
    got_h, got_b = PACKAGES[dst].unpack_frame(frame)
    ref_h, ref_b = PACKAGES[src].unpack_frame(frame)
    assert got_h == ref_h
    assert {k: bytes(v) for k, v in got_b.items()} == blobs
    assert {k: bytes(v) for k, v in ref_b.items()} == blobs
    assert (tt.frame_saved_bytes(got_h) == jt.frame_saved_bytes(ref_h))
    meta = {m["n"]: m for m in got_h["blobs"]}
    assert meta["noise"]["comp"] == "none"  # did not pay for itself
    if tt.effective_codec(codec) == "zstd":
        assert meta["table"]["comp"] == "zstd"
        assert tt.frame_saved_bytes(got_h) > 0


def test_mixed_codec_frame_and_adaptive_blobs_cross():
    """The adaptive per-column plane's frame (per-blob codecs) from each
    package's `encode_table_adaptive` of one table: the same blobs, codec
    picks and frame bytes, decoding to equal tables in both packages."""
    rng = np.random.default_rng(5)
    arrow = pa.table({
        "k": rng.integers(0, 40, 4096),
        "v": rng.normal(size=4096),
        "s": pa.array(rng.choice(["x", "yy", "zzz"], 4096)),
    })
    tb, tc = tcodec.encode_table_adaptive(
        t_arrow(arrow, device="cpu"), tt.supported_codecs())
    jb, jc = jcodec.encode_table_adaptive(j_arrow(arrow),
                                          jt.supported_codecs())
    assert tc == jc
    assert {k: bytes(v) for k, v in tb.items()} == {
        k: bytes(v) for k, v in jb.items()}
    frame = tt.pack_frame({"cols": len(tb)}, tb, codec="zstd", codecs=tc)
    assert frame == jt.pack_frame({"cols": len(jb)}, jb, codec="zstd",
                                  codecs=jc)
    h, out = jt.unpack_frame(frame)
    back = jcodec.decode_table_adaptive(out, h["cols"]).to_numpy()
    h2, out2 = tt.unpack_frame(frame)
    mine = tcodec.decode_table_adaptive(out2, h2["cols"],
                                        device="cpu").to_numpy()
    assert list(back) == list(mine)
    for col in back:
        np.testing.assert_array_equal(np.asarray(back[col]),
                                      np.asarray(mine[col]), err_msg=col)


@pytest.mark.parametrize("requested", ["zstd", "lz4", "none", "brotli"])
@pytest.mark.parametrize("peer", [None, [], ["none"], ["none", "zstd"],
                                  ["none", "lz4"],
                                  ["none", "zstd", "lz4"]],
                         ids=["none-advertised", "empty", "only-none",
                              "zstd", "lz4", "all"])
def test_codec_negotiation_matches_the_reference(requested, peer):
    assert tt.negotiate_codec(requested, peer) == jt.negotiate_codec(
        requested, peer)


def test_lz4_gated_as_in_the_reference():
    assert tt.supported_codecs() == jt.supported_codecs()
    assert "none" in tt.supported_codecs()
    for c in ("lz4", "zstd", "none"):
        assert tt.effective_codec(c) == jt.effective_codec(c)
    if "lz4" not in tt.supported_codecs():
        # requested lz4 downgrades, and an lz4 blob cannot be read here
        assert tt.effective_codec("lz4") == tt.effective_codec("zstd")
        with pytest.raises(RuntimeError, match="lz4"):
            tt.decompress(b"x", "lz4")
        assert tt.compress(b"abc" * 100, "lz4") == b"abc" * 100


def test_chunks_and_budget():
    frame = tt.pack_frame({}, _blobs(2), codec="none")
    pieces = list(tt.iter_chunks(frame, 1000))
    assert pieces == list(jt.iter_chunks(frame, 1000))
    assert max(len(p) for p in pieces) == 1000
    assert tt.collect_chunks(iter(pieces)) == frame
    with pytest.raises(RuntimeError, match="budget"):
        tt.collect_chunks(iter(pieces), budget_bytes=len(frame) - 1)


def test_wire_stats_count_unpacked_frames():
    blobs = _blobs(3)
    frame = tt.pack_frame({}, blobs, codec="zstd")
    tt.reset_wire_stats()
    tt.unpack_frame(frame)
    tt.unpack_frame(frame)
    st = tt.wire_stats()
    assert st["frames"] == 2
    assert st["wire_bytes"] == 2 * len(frame)
    assert st["raw_bytes"] == 2 * sum(len(b) for b in blobs.values())
    header, _ = jt.unpack_frame(frame)
    assert st["saved_bytes"] == 2 * jt.frame_saved_bytes(header) > 0
    tt.reset_wire_stats()
    assert tt.wire_stats() == {"frames": 0, "wire_bytes": 0, "raw_bytes": 0,
                               "saved_bytes": 0}
