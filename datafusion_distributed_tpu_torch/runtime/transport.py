"""Binary wire framing + compression for the worker transport.

The reference's data plane is Arrow Flight with lz4/zstd IPC compression
(`impl_execute_task.rs:137-144`), streamed in batches with a 64 MiB
connection buffer budget (`worker_connection_pool.rs:295-308`). This
module is the wire format of the gRPC tier (runtime/grpc_worker.py):

    frame   := header_len:u32 | header_json | blob*
    header  := {"k": ..., "blobs": [{"n": name, "len": int, "comp": str}]}

Blobs are Arrow-IPC table bytes, optionally zstd-compressed (self-describing
per blob, so endpoints can mix settings). Chunked iteration slices a frame
into fixed-size pieces for gRPC streaming — gRPC's own flow control then
gives per-stream backpressure, the budget caps how far a consumer reads
ahead.

Port of the reference `runtime/transport.py`: the same frames byte for
byte (zstd at level 1; lz4 optional and gated as there), so a frame
packed by either package unpacks in the other. Beside it the port counts
what crosses the wire (`wire_stats`): frames unpacked, their bytes as
framed, their blobs' bytes after decompression and the bytes compression
saved.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Iterable, Iterator, Optional

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover - zstd is installed where the port runs
    _zstd = None

try:  # lz4 is OPTIONAL (absent where the port runs): every path gates
    import lz4.frame as _lz4
except Exception:
    _lz4 = None

DEFAULT_CHUNK_BYTES = 1 << 20

_stats_lock = threading.Lock()
_STATS = {"frames": 0, "wire_bytes": 0, "raw_bytes": 0,
          "saved_bytes": 0}  # guarded-by: _stats_lock


def compress(data: bytes, codec: str) -> bytes:
    if codec == "zstd" and _zstd is not None:
        return _zstd.ZstdCompressor(level=1).compress(data)
    if codec == "lz4" and _lz4 is not None:
        return _lz4.compress(bytes(data))
    return data


def decompress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if _zstd is None:
            raise RuntimeError("zstd frame received but zstandard missing")
        return _zstd.ZstdDecompressor().decompress(data)
    if codec == "lz4":
        if _lz4 is None:
            raise RuntimeError("lz4 frame received but lz4 missing")
        return _lz4.decompress(data)
    return data


def effective_codec(codec: str) -> str:
    """Downgrade a requested codec to what THIS process can actually
    produce (lz4 -> zstd -> none): the frame stays self-describing, so a
    downgraded producer never strands a consumer."""
    if codec == "lz4" and _lz4 is None:
        codec = "zstd"
    if codec == "zstd" and _zstd is None:
        return "none"
    return codec


def supported_codecs() -> list[str]:
    """Codecs this process can DECODE (and encode) — the per-connection
    negotiation surface: workers advertise it through GetInfo and
    clients intersect before choosing a wire codec."""
    out = ["none"]
    if _zstd is not None:
        out.append("zstd")
    if _lz4 is not None:
        out.append("lz4")
    return out


def negotiate_codec(requested: str, peer_codecs) -> str:
    """The codec to put on the wire toward a peer advertising
    ``peer_codecs``: the requested codec when both ends speak it, else
    the best shared fallback (zstd, then none). An empty/unknown
    advertisement (an old worker's GetInfo without the field) falls back
    to `effective_codec` alone — this end's capabilities."""
    requested = effective_codec(requested)
    if not peer_codecs:
        return requested
    peers = set(peer_codecs)
    if requested in peers:
        return requested
    if "zstd" in peers and _zstd is not None:
        return "zstd"
    return "none"


def frame_saved_bytes(header: dict) -> int:
    """Wire bytes compression saved in an unpacked frame's header (the
    ``raw_len`` vs ``len`` blob meta delta) — feeds the
    `dftpu_wire_bytes_saved` telemetry dimension."""
    saved = 0
    for m in header.get("blobs", []):
        raw = m.get("raw_len")
        if raw is not None:
            saved += max(int(raw) - int(m["len"]), 0)
    return saved


def pack_frame(header: dict, blobs: dict[str, bytes],
               codec: str = "zstd", codecs=None) -> bytes:
    """-> one binary frame; blobs compressed with ``codec`` (or a
    per-blob override from the ``codecs`` name->codec map — the adaptive
    per-column plane mixes codecs within one frame; per-blob ``comp``
    framing keeps the result self-describing)."""
    codec = effective_codec(codec)
    parts = []
    meta = []
    for name, raw in blobs.items():
        blob_codec = codec
        if codecs is not None and name in codecs:
            blob_codec = effective_codec(codecs[name])
        c = compress(raw, blob_codec)
        # compression that doesn't pay for itself ships raw
        if len(c) >= len(raw):
            c, used = raw, "none"
        else:
            used = blob_codec
        meta.append({"n": name, "len": len(c), "comp": used,
                     "raw_len": len(raw)})
        parts.append(c)
    header = dict(header)
    header["blobs"] = meta
    hj = json.dumps(header).encode()
    return b"".join([struct.pack("<I", len(hj)), hj] + parts)


def unpack_frame(frame: bytes) -> tuple[dict, dict[str, bytes]]:
    (hlen,) = struct.unpack_from("<I", frame, 0)
    header = json.loads(frame[4: 4 + hlen].decode())
    blobs: dict[str, bytes] = {}
    off = 4 + hlen
    raw_total = 0
    for m in header.get("blobs", []):
        raw = decompress(frame[off: off + m["len"]], m["comp"])
        blobs[m["n"]] = raw
        raw_total += len(raw)
        off += m["len"]
    with _stats_lock:
        _STATS["frames"] += 1
        _STATS["wire_bytes"] += len(frame)
        _STATS["raw_bytes"] += raw_total
        _STATS["saved_bytes"] += frame_saved_bytes(header)
    return header, blobs


def wire_stats() -> dict:
    """Frames this process unpacked since the last `reset_wire_stats`:
    how many, their framed bytes (what crossed the wire), their blobs'
    bytes after decompression and what compression saved
    (`frame_saved_bytes`)."""
    with _stats_lock:
        return dict(_STATS)


def reset_wire_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


def iter_chunks(frame: bytes,
                chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Iterator[bytes]:
    for off in range(0, len(frame), chunk_bytes):
        yield frame[off: off + chunk_bytes]


def collect_chunks(chunks: Iterable[bytes],
                   budget_bytes: Optional[int] = None) -> bytes:
    """Reassemble a chunk stream. ``budget_bytes`` is a hard cap on the
    bytes buffered (the connection-budget analogue — with gRPC streaming the
    producer is flow-controlled, so exceeding the cap means the payload is
    simply bigger than allowed)."""
    parts = []
    total = 0
    for c in chunks:
        total += len(c)
        if budget_bytes is not None and total > budget_bytes:
            raise RuntimeError(
                f"stream exceeds connection buffer budget "
                f"({total} > {budget_bytes} bytes)"
            )
        parts.append(c)
    return b"".join(parts)
