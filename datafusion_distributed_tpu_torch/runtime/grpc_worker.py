"""gRPC transport for the worker service (multi-host deployments).

The reference's workers are tonic gRPC services speaking a protobuf contract
(CoordinatorChannel, ExecuteTask, GetWorkerInfo) with Arrow Flight framing
on the data plane. Here the same worker object (runtime/worker.py) is
exposed over gRPC generic handlers:

    control plane: SetPlan (binary frame: plan JSON header + zstd Arrow-IPC
                   table slices — runtime/transport.py)
    data plane:    ExecuteTask -> server-streamed chunked binary frame;
                   gRPC flow control gives per-stream backpressure, the
                   64 MiB connection budget caps read-ahead, cancellation
                   propagates via stream teardown; TransferPartitions ->
                   the same partition chunks as shm segment references
                   (co-located) or adaptively compressed frames (remote)
    observability: GetInfo / GetMetrics / TaskProgress

`GrpcWorkerClient` implements the same duck-typed surface as `Worker`, so
the Coordinator runs unchanged over in-process or remote workers — the
LocalWorkerConnection-vs-RemoteWorkerConnection duality of the reference
(`worker_connection_pool.rs:48-60`). `start_localhost_cluster` is the
`start_localhost_context` test fixture: real sockets, one process.

Port of the reference `runtime/grpc_worker.py`. This is the tier that moves
table bytes off the card on purpose: a producer's output (or a partition
of it) is copied to the host once, encoded as Arrow IPC and framed; the
receiver decodes it onto the device it names and copies it there once.
Every decode has a named device: a server decodes onto its worker's
``device``, a client onto its own (the coordinator session's, given to
`start_localhost_cluster`). Handlers run on the server's thread pool; each
enters its worker's device and enqueues on that thread's current stream
(the device's one stream): no handler gets a stream of its own, since two
cooperative build launches on two streams can hang. ``rpc_timeout_s``
gives every RPC a client makes without its own deadline one, so a hung
stream fails (retryably) instead of blocking its caller.
"""

from __future__ import annotations

import contextlib
import json
import threading
from concurrent import futures
from typing import Optional

import torch

from datafusion_distributed_tpu_torch.io.parquet import (
    DictionaryMissing,
    advertised,
    held_dictionaries,
)
from datafusion_distributed_tpu_torch.ops.table import Table
from datafusion_distributed_tpu_torch.runtime import transport
from datafusion_distributed_tpu_torch.runtime.codec import (
    TableStore,
    collect_table_ids,
    decode_table,
    encode_table,
)
from datafusion_distributed_tpu_torch.runtime.errors import (
    TaskTimeoutError,
    TransportError,
    WorkerError,
    WorkerUnavailableError,
    wrap_worker_exception,
)
from datafusion_distributed_tpu_torch.runtime.worker import TaskKey, Worker

_SERVICE = "dftpu.Worker"
_OPTIONS = [
    ("grpc.max_receive_message_length", -1),
    ("grpc.max_send_message_length", -1),
]


def _map_rpc_error(e, url: str, key=None) -> WorkerError:
    """gRPC status -> the retryable/fatal taxonomy (runtime/errors.py):
    DEADLINE_EXCEEDED is a blown deadline, UNAVAILABLE an unreachable or
    crashed endpoint, everything else a transport fault — all retryable, so
    the coordinator reroutes instead of failing the query on a flaky link.
    Errors the SERVER classified ride the E-frame payload, not gRPC status,
    and never reach this mapping."""
    import grpc

    code = e.code() if isinstance(e, grpc.RpcError) else None
    detail = None
    try:
        detail = e.details()
    except Exception:
        pass
    msg = f"rpc {code.name if code else type(e).__name__}: {detail or e}"
    if code == grpc.StatusCode.DEADLINE_EXCEEDED:
        cls = TaskTimeoutError
    elif code == grpc.StatusCode.UNAVAILABLE:
        cls = WorkerUnavailableError
    else:
        cls = TransportError
    return cls(msg, worker_url=url, task=key,
               original_type=type(e).__name__)


def _key_to_obj(key: TaskKey) -> list:
    return [key.query_id, key.stage_id, key.task_number]


def _key_from_obj(o) -> TaskKey:
    return TaskKey(o[0], o[1], o[2])


def _encode(table: Table, sent: Optional[set] = None):
    """A table's wire payload: Arrow IPC of its live rows, each string
    column with its whole dictionary and unchanged codes. A hash exchange
    downstream routes string keys by their codes, so every task must read a
    code as the same string, as tasks sharing one dictionary in process
    do: with per-payload GC'd dictionaries (the reference's wire encoding)
    the same string takes other codes on other tasks, and a GROUP BY on it
    splits its groups (TPC-H q5 at SF 0.1 over four gRPC workers returned
    seven rows for five nations). ``sent``: the fingerprints of the
    dictionaries the receiver holds (it advertised them, or earlier
    payloads of the stream or frame carried them), which the payload
    references instead of repeating them (TPC-H q21 ships `l_comment`'s
    dictionary, 4.5 million strings at SF 1, with every lineitem slice)."""
    return encode_table(table, whole_dictionaries=True, sent=sent)


def _on_device(device: torch.device):
    """Enter ``device`` in the calling thread (a handler thread of the
    server's pool): its kernels then go to that device's current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def _handlers(worker: Worker):
    import grpc

    # segments published for a task's transfer streams whose tokens the
    # client may never release (it tears the stream with S-frames still
    # buffered): reclaimed when the client's `_release_incomplete` sends
    # Invalidate for the task, and bounded by an oldest-first sweep for
    # cleanly drained streams that never invalidate. Token release is
    # idempotent, so reclaiming a segment the client DID consume is a
    # no-op.
    task_shm_tokens: dict = {}  # guarded-by: task_shm_lock
    task_shm_lock = threading.Lock()

    def _reclaim_task_segments(key) -> None:
        with task_shm_lock:
            tokens = task_shm_tokens.pop(key, [])
            while len(task_shm_tokens) > 256:
                tokens.extend(
                    task_shm_tokens.pop(next(iter(task_shm_tokens)))
                )
        for name, token in tokens:
            try:
                worker.segment_pool.release(name, token)
            except Exception:
                pass  # reclaim must never mask the caller's own path

    def set_plan(request: bytes, context) -> bytes:
        header, blobs = transport.unpack_frame(request)
        key = _key_from_obj(header["key"])
        caps = header.get("table_caps") or {}
        try:
            # materialize shipped table slices into the worker's store at
            # their ORIGINAL padded capacities (the client-side comment on
            # table_caps: re-padding would change the plan fingerprint),
            # on the worker's device; put_as routes through the store's
            # byte accounting AND the enforced-budget gate, attributed to
            # the shipping query
            from datafusion_distributed_tpu_torch.runtime.codec import (
                staging_attribution,
            )

            # the dictionaries the frame carries: its later blobs, and the
            # client's later frames (the response lists the large ones),
            # reference them
            held: dict = {}
            with _on_device(worker.device), \
                    staging_attribution(key.query_id):
                for tid, raw in blobs.items():
                    worker.table_store.put_as(tid, decode_table(
                        raw, capacity=caps.get(tid), device=worker.device,
                        held=held))
                worker.set_plan(key, header["plan"], header["task_count"],
                                config=header.get("config"),
                                headers=header.get("headers"),
                                ttl=header.get("ttl"))
            return json.dumps({"ok": True,
                               "have": advertised(held)}).encode()
        except DictionaryMissing as e:
            # the client believed this process held a dictionary it no
            # longer does: it ships the frame again with the values
            worker.table_store.remove(list(blobs))
            return json.dumps({"dict_missing": e.fingerprints}).encode()
        except WorkerError as e:
            # a failed set_plan registered no entry to own the staged
            # slices — release them or they leak until process exit
            worker.table_store.remove(list(blobs))
            return json.dumps({"error": e.to_dict()}).encode()
        except Exception as e:  # structured contract for transport errors too
            worker.table_store.remove(list(blobs))
            return json.dumps(
                {"error": wrap_worker_exception(e, worker.url, key).to_dict()}
            ).encode()

    def execute_task(request: bytes, context):
        """Server-streaming. Three protocols:

        bulk (no chunk_rows): header+table as ONE framed payload sliced
        into transport pieces; the client's read pace backpressures via
        gRPC flow control.

        streaming (chunk_rows > 0): a header message then one framed
        message PER ROW CHUNK — rows after a client cancellation are never
        even encoded (the reference's dropped-stream early exit,
        `impl_execute_task.rs:97-112`). The output's live rows are copied
        to the host once; every chunk is a host view of that copy.

        partition-multiplexed (partitions): chunks of a partition range,
        each tagged with its partition id."""
        msg = json.loads(request.decode())
        key = _key_from_obj(msg["key"])
        codec = msg.get("compression", "zstd")
        chunk = int(msg.get("chunk_bytes", transport.DEFAULT_CHUNK_BYTES))
        chunk_rows = int(msg.get("chunk_rows", 0))
        parts = msg.get("partitions")
        with _on_device(worker.device):
            if parts:
                yield from _partition_stream(msg, key, parts, codec,
                                             chunk_rows, context)
                return
            yield from _task_stream(msg, key, codec, chunk, chunk_rows,
                                    context)

    def _partition_stream(msg, key, parts, codec, chunk_rows, context):
        # partition-range multiplex: one stream serves partitions
        # [lo, hi) of the task's hash-partitioned output; each chunk
        # message is tagged with its partition id (the reference's
        # FlightAppMetadata partition tag, `impl_execute_task.rs:
        # 146-158`); accounting/invalidation is the worker's
        # drop-driven partitions_remaining, NOT this handler's finally
        sent = set(msg.get("have") or ())
        try:
            for p, piece, _est in worker.execute_task_partitions(
                key, parts["keys"], int(parts["num"]),
                int(parts["lo"]), int(parts["hi"]),
                per_dest_capacity=int(parts.get("per_dest_cap", 0)),
                chunk_rows=chunk_rows or 65536, on_host=True,
            ):
                if not context.is_active():  # cancelled: stop producing
                    return
                yield b"P" + transport.pack_frame(
                    {"part": p}, {"table": _encode(piece, sent)},
                    codec=codec,
                )
            yield b"H" + json.dumps(
                {"progress": worker.task_progress(key)}
            ).encode()
        except WorkerError as e:
            yield b"E" + json.dumps(e.to_dict()).encode()
        except Exception as e:
            yield b"E" + json.dumps(
                wrap_worker_exception(e, worker.url, key).to_dict()
            ).encode()
        finally:
            if worker.partitions_remaining(key) in (None, 0):
                worker.table_store.remove(msg.get("table_ids", []))

    def _task_stream(msg, key, codec, chunk, chunk_rows, context):
        from datafusion_distributed_tpu_torch.ops.table import (
            host_rows,
            slice_view,
            zero_copy_enabled,
        )
        from datafusion_distributed_tpu_torch.runtime.codec import (
            _live_on_host,
        )

        try:
            try:
                out = worker.execute_task(key)
                # progress rides the response: the registry entry is
                # invalidated below, so a later TaskProgress call couldn't
                # see it
                progress = worker.task_progress(key)
            except WorkerError as e:
                yield b"E" + json.dumps(e.to_dict()).encode()
                return
            except Exception as e:
                yield b"E" + json.dumps(
                    wrap_worker_exception(e, worker.url, key).to_dict()
                ).encode()
                return
            if chunk_rows > 0:
                yield b"H" + json.dumps({"progress": progress}).encode()
                # honor the session's `SET distributed.zero_copy` (the
                # coordinator ships it in the task config; the entry is
                # still registered — this handler's finally invalidates)
                data = worker.registry.get(key)
                zc = zero_copy_enabled(
                    data.config if data is not None else None
                )
                # one device-to-host copy of the live rows; every chunk
                # is cut from that host copy
                out = _live_on_host(out)
                n = host_rows(out)
                sent = set(msg.get("have") or ())
                for lo in range(0, max(n, 1), chunk_rows):
                    if not context.is_active():  # cancelled: stop producing
                        return
                    count = min(chunk_rows, n - lo)
                    piece = (slice_view(out, lo, count) if zc
                             else out.slice_rows(lo, count))
                    yield b"T" + transport.pack_frame(
                        {}, {"table": _encode(piece, sent)}, codec=codec
                    )
                return
            frame = transport.pack_frame(
                {"progress": progress},
                {"table": _encode(out, set(msg.get("have") or ()))},
                codec=codec,
            )
            for piece in transport.iter_chunks(frame, chunk):
                if not context.is_active():
                    return
                yield b"D" + piece
        finally:
            worker.registry.invalidate(key)
            worker.table_store.remove(msg.get("table_ids", []))

    def transfer_partitions(request: bytes, context):
        """Server-streaming DoGet-style transfer: serves the SAME
        partition-chunk sequence as `execute_task` partition multiplexing
        — the planes' byte-identity contract — but classifies the hop
        first:

        co-located (client hostname == ours): each chunk's Arrow IPC
        payload is PUBLISHED into the worker's segment pool and the
        stream carries only an S-frame reference {dir, seg, token} —
        zero payload bytes on the wire; the consumer reads the segment
        and drops its reference.

        remote: chunks ship as wire frames with ADAPTIVE per-column
        compression (A-frames, runtime/codec.encode_table_adaptive)
        under the codec set both ends negotiated, falling back to
        single-blob P-frames for tiny payloads or forced codecs."""
        with _on_device(worker.device):
            yield from _transfer(request, context)

    def _transfer(request: bytes, context):
        from datafusion_distributed_tpu_torch.runtime.codec import (
            ADAPTIVE_MIN_BYTES,
            encode_table_adaptive,
        )
        from datafusion_distributed_tpu_torch.runtime.shm_plane import (
            SegmentError,
            SegmentPool,
        )

        msg = json.loads(request.decode())
        key = _key_from_obj(msg["key"])
        chunk_rows = int(msg.get("chunk_rows", 65536)) or 65536
        parts = msg["partitions"]
        peer_codecs = msg.get("wire_codecs") or None
        wire_mode = msg.get("wire_compression", "auto")
        base = transport.negotiate_codec(
            msg.get("compression", "zstd"), peer_codecs
        )
        if wire_mode in ("zstd", "lz4"):
            base = transport.negotiate_codec(wire_mode, peer_codecs)
        elif wire_mode == "off":
            base = "none"
        # adaptive picks only from codecs BOTH ends decode
        allowed = [
            c for c in transport.supported_codecs()
            if peer_codecs is None or c in peer_codecs
        ]
        pool = worker.segment_pool
        serve_shm = SegmentPool.same_host(msg.get("shm"))
        shm_tokens: list = []
        # the dictionaries the client holds: those it advertised and those
        # this stream's frames carried (S, A and P alike: the client decodes
        # them in stream order into one `held`)
        sent = set(msg.get("have") or ())
        drained = False
        try:
            for p, piece, est in worker.execute_task_partitions(
                key, parts["keys"], int(parts["num"]),
                int(parts["lo"]), int(parts["hi"]),
                per_dest_capacity=int(parts.get("per_dest_cap", 0)),
                chunk_rows=chunk_rows, on_host=True,
            ):
                if not context.is_active():  # cancelled: stop producing
                    return
                if serve_shm:
                    # the dictionaries count as sent only once the segment
                    # is published
                    trial = set(sent)
                    payload = _encode(piece, trial)
                    try:
                        name, token = pool.publish(
                            payload, int(getattr(piece, "capacity", 0))
                        )
                    except SegmentError:
                        # pool unusable (disk full/gone): the REST of the
                        # stream goes over the wire path
                        serve_shm = False
                    else:
                        sent = trial
                        shm_tokens.append((name, token))
                        with task_shm_lock:
                            task_shm_tokens.setdefault(key, []).append(
                                (name, token)
                            )
                        yield b"S" + json.dumps({
                            "part": p, "seg": name, "token": token,
                            "dir": pool.descriptor()["dir"],
                            "nbytes": len(payload),
                        }).encode()
                        continue
                if wire_mode == "auto" and est > ADAPTIVE_MIN_BYTES:
                    blobs, col_codecs = encode_table_adaptive(
                        piece, allowed, whole_dictionaries=True, sent=sent
                    )
                    if blobs:
                        yield b"A" + transport.pack_frame(
                            {"part": p, "cols": len(blobs)}, blobs,
                            codec=base, codecs=col_codecs,
                        )
                        continue
                yield b"P" + transport.pack_frame(
                    {"part": p}, {"table": _encode(piece, sent)},
                    codec=base,
                )
            yield b"H" + json.dumps(
                {"progress": worker.task_progress(key)}
            ).encode()
            drained = True
        except WorkerError as e:
            yield b"E" + json.dumps(e.to_dict()).encode()
        except Exception as e:
            yield b"E" + json.dumps(
                wrap_worker_exception(e, worker.url, key).to_dict()
            ).encode()
        finally:
            if not drained:
                # the producer side never finished: S-frames the client
                # will never open still hold their publish token —
                # reclaim this stream's own publishes (idempotent per
                # token, so segments the client DID consume-and-release
                # are untouched). A stream that drained server-side can
                # STILL be torn by the client with S-frames buffered;
                # that path is reclaimed by the client's Invalidate (its
                # `_release_incomplete`) via `_reclaim_task_segments`.
                for name, token in shm_tokens:
                    try:
                        pool.release(name, token)
                    except Exception:
                        pass
            if worker.partitions_remaining(key) in (None, 0):
                worker.table_store.remove(msg.get("table_ids", []))

    def get_info(request: bytes, context) -> bytes:
        return json.dumps(worker.get_info()).encode()

    def get_metrics(request: bytes, context) -> bytes:
        # telemetry exposition (runtime/telemetry.py): the snapshot is
        # JSON-able by construction; the client (or the observability
        # service) renders OpenMetrics text from it after merging
        return json.dumps({"metrics": worker.get_metrics()}).encode()

    def task_progress(request: bytes, context) -> bytes:
        msg = json.loads(request.decode())
        p = worker.task_progress(_key_from_obj(msg["key"]))
        return json.dumps({"progress": p}).encode()

    def invalidate(request: bytes, context) -> bytes:
        # query-end release (the coordinator's EOS sweep for peer-plane
        # producer tasks that were never, or only partially, pulled)
        msg = json.loads(request.decode())
        key = _key_from_obj(msg["key"])
        worker.release_task(key)
        _reclaim_task_segments(key)
        return json.dumps({"ok": True}).encode()

    unary = {
        "SetPlan": set_plan,
        "GetInfo": get_info,
        "GetMetrics": get_metrics,
        "TaskProgress": task_progress,
        "Invalidate": invalidate,
    }
    method_handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=None, response_serializer=None
        )
        for name, fn in unary.items()
    }
    method_handlers["ExecuteTask"] = grpc.unary_stream_rpc_method_handler(
        execute_task, request_deserializer=None, response_serializer=None
    )
    method_handlers["TransferPartitions"] = (
        grpc.unary_stream_rpc_method_handler(
            transfer_partitions,
            request_deserializer=None, response_serializer=None,
        )
    )
    return grpc.method_handlers_generic_handler(_SERVICE, method_handlers)


def serve_worker(worker: Worker, port: int = 0, host: str = "0.0.0.0",
                 device=None):
    """-> (grpc.Server, bound_port). Unlimited message sizes, matching the
    reference's into_worker_server (`worker_service.rs:127-158`). Binds to
    all interfaces by default (multi-host); pass host="127.0.0.1" for a
    loopback-only fixture. ``device``: where the server decodes the tables
    shipped to ``worker`` (None keeps the worker's own ``device``)."""
    import grpc

    if device is not None:
        worker.device = torch.device(device)
    # Peer-plane recursion holds a server thread per in-flight consumer
    # execute while its producer streams are served by the SAME pool (a
    # deep staged query can pin several threads per worker); size the pool
    # well past the worst realistic stage depth x concurrent streams.
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=32), options=_OPTIONS,
    )
    server.add_generic_rpc_handlers((_handlers(worker),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class GrpcWorkerClient:
    """Duck-typed as `Worker` for the Coordinator: set_plan / execute_task /
    get_info / task_progress / table_store / registry. ``device``: where
    the tables this client receives are decoded (None: the card).
    ``rpc_timeout_s``: the deadline of every RPC made without one."""

    def __init__(self, url: str, compression: str = "zstd",
                 chunk_bytes: int = transport.DEFAULT_CHUNK_BYTES,
                 device=None, rpc_timeout_s: Optional[float] = None):
        # (in-flight byte budgeting lives in the coordinator's streaming
        # plane, runtime/streams.py — not per-connection)
        import grpc

        self.url = url
        self.compression = transport.effective_codec(compression)
        self.chunk_bytes = chunk_bytes
        self.device = torch.device("cuda" if device is None else device)
        self.rpc_timeout_s = rpc_timeout_s
        target = url.removeprefix("grpc://")
        self._channel = grpc.insecure_channel(target, options=_OPTIONS)
        self.table_store = TableStore()  # filled by encode_plan pre-flight
        self.registry = _NullRegistry()
        self._shipped_ids: dict[TaskKey, list] = {}
        self._progress_cache: dict[TaskKey, Optional[dict]] = {}
        # per-CONNECTION negotiated codec (None until the first data
        # call asks the server what it decodes)
        self._negotiated_codec: Optional[str] = None
        # set after a SegmentError: the shm plane stays off for this
        # connection (retries re-pull over the wire path)
        self._shm_broken = False
        # chaos hook (runtime/chaos.py kind="segment_lost"): tear the
        # next S-frame's segment before opening it
        self._chaos_tear_next_segment = False
        # fingerprints of the dictionaries the server said it adopted
        # (SetPlan responses): later frames reference them
        self._peer_has: set = set()  # guarded-by: _peer_lock
        self._peer_lock = threading.Lock()

    def _deadline(self, timeout: Optional[float]) -> Optional[float]:
        return timeout if timeout else self.rpc_timeout_s

    def _decode(self, payload, held: Optional[dict] = None) -> Table:
        with _on_device(self.device):
            return decode_table(payload, device=self.device, held=held)

    def close(self) -> None:
        """Close the channel (its sockets and threads)."""
        self._channel.close()

    def _wire_codec(self) -> str:
        """The codec this connection puts on the wire: the constructor's
        request intersected with the SERVER's advertised `wire_codecs`
        (GetInfo), negotiated once per connection. A server without the
        field (version skew) or an unreachable GetInfo falls back to this
        end's `effective_codec` alone — the frame stays self-describing
        either way, so a mistaken pick degrades, never corrupts."""
        cached = self._negotiated_codec
        if cached is None:
            try:
                peer = self.get_info().get("wire_codecs")
            except Exception:
                peer = None
            cached = transport.negotiate_codec(self.compression, peer)
            self._negotiated_codec = cached
        return cached

    def _call(self, method: str, payload: dict,
              timeout: Optional[float] = None) -> dict:
        import grpc

        rpc = self._channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=None,
            response_deserializer=None,
        )
        try:
            resp = rpc(json.dumps(payload).encode(),
                       timeout=self._deadline(timeout))
        except grpc.RpcError as e:
            raise _map_rpc_error(e, self.url) from e
        msg = json.loads(resp.decode())
        if "error" in msg:
            raise WorkerError.from_dict(msg["error"])
        return msg

    def set_plan(self, key: TaskKey, plan_obj: dict, task_count: int,
                 config: Optional[dict] = None,
                 headers: Optional[dict] = None,
                 ttl: Optional[float] = None,
                 timeout: Optional[float] = None) -> int:
        """``timeout``: dispatch deadline, enforced by gRPC itself;
        DEADLINE_EXCEEDED surfaces as the retryable TaskTimeoutError.

        -> the framed wire bytes this ship put on the wire (compressed
        payload + codec framing): returned, not stashed on the client —
        clients are cached per url and shared across concurrent
        dispatches, so instance state would attribute one thread's frame
        size to another's dispatch span (runtime/tracing.py)."""
        tids = collect_table_ids(plan_obj)
        self._shipped_ids[key] = tids
        with self._peer_lock:
            sent = set(self._peer_has)
        msg, n = self._ship_plan(key, plan_obj, task_count, config, headers,
                                 ttl, timeout, tids, sent)
        if "dict_missing" in msg:
            # the server dropped dictionaries it had adopted: once more,
            # every dictionary with its values
            with self._peer_lock:
                self._peer_has.difference_update(msg["dict_missing"])
            msg, n = self._ship_plan(key, plan_obj, task_count, config,
                                     headers, ttl, timeout, tids, set())
        if "error" in msg or "dict_missing" in msg:
            self._shipped_ids.pop(key, None)
            self.table_store.remove(tids)
            if "error" in msg:
                raise WorkerError.from_dict(msg["error"])
            raise WorkerError(
                f"worker {self.url} lost wire dictionaries twice: "
                f"{msg['dict_missing']}", worker_url=self.url, task=key)
        with self._peer_lock:
            self._peer_has.update(msg.get("have", ()))
        # local copies served their purpose once serialized
        self.table_store.remove(tids)
        return n

    def _ship_plan(self, key, plan_obj, task_count, config, headers, ttl,
                   timeout, tids, sent) -> tuple:
        """One SetPlan call: -> (the server's response, framed bytes)."""
        import grpc

        blobs = {
            tid: _encode(self.table_store.get(tid), sent) for tid in tids
        }
        frame = transport.pack_frame(
            {
                "key": _key_to_obj(key),
                "plan": plan_obj,
                "task_count": task_count,
                "config": config or {},
                "headers": headers or {},
                "ttl": ttl,
                # padded capacities of the shipped tables: the wire payload
                # only carries live rows, so without these the server would
                # re-pad to pow2(rows) — changing leaf capacities, and with
                # them the plan's structural fingerprint (breaking the
                # post-decode DFTPU043 check)
                "table_caps": {
                    tid: int(self.table_store.get(tid).capacity)
                    for tid in tids
                },
            },
            blobs,
            codec=self._wire_codec(),
        )
        del blobs
        rpc = self._channel.unary_unary(
            f"/{_SERVICE}/SetPlan",
            request_serializer=None, response_deserializer=None,
        )
        try:
            return (json.loads(
                rpc(frame, timeout=self._deadline(timeout)).decode()),
                len(frame))
        except grpc.RpcError as e:
            # the ship may or may not have landed server-side; drop the
            # local copies either way (a retry re-encodes) and let the
            # retryable mapped error drive rerouting. Best-effort
            # Invalidate: a deadline-abandoned server handler may still
            # register the entry, pinning decoded slices on the struggling
            # worker until the TTL sweep — narrow the window (the sweep
            # remains the backstop for registrations landing after this)
            self._shipped_ids.pop(key, None)
            self.table_store.remove(tids)
            try:
                self._call("Invalidate", {"key": _key_to_obj(key)},
                           timeout=5.0)
            except Exception:
                pass
            raise _map_rpc_error(e, self.url, key) from e

    def execute_task(self, key: TaskKey,
                     timeout: Optional[float] = None) -> Table:
        import grpc

        rpc = self._channel.unary_stream(
            f"/{_SERVICE}/ExecuteTask",
            request_serializer=None, response_deserializer=None,
        )
        held = held_dictionaries()  # advertised, and held for the stream
        req = json.dumps({
            "key": _key_to_obj(key),
            "table_ids": self._shipped_ids.pop(key, []),
            "compression": self._wire_codec(),
            "chunk_bytes": self.chunk_bytes,
            "have": list(held),
        }).encode()
        stream = rpc(req, timeout=self._deadline(timeout))

        def chunks():
            try:
                for piece in stream:
                    tag, body = piece[:1], piece[1:]
                    if tag == b"E":
                        raise WorkerError.from_dict(json.loads(body.decode()))
                    yield body
            except grpc.RpcError as e:
                stream.cancel()
                raise _map_rpc_error(e, self.url, key) from e
            except BaseException:
                stream.cancel()  # cancellation propagates to the producer
                raise

        # NOTE: gRPC's stream flow control is the read-ahead backpressure
        # (the reference's 64 MiB budget role); the budget is NOT a cap on
        # result size — large-but-valid outputs must stream through.
        frame = transport.collect_chunks(chunks())
        header, blobs = transport.unpack_frame(frame)
        # server invalidates its registry after the call; progress rides the
        # response and is served from this cache
        self._progress_cache[key] = header.get("progress")
        return self._decode(blobs["table"], held)

    def execute_task_stream(self, key: TaskKey, chunk_rows: int = 65536,
                            cancel=None):
        """Streaming protocol: yields (chunk Table, wire_bytes). Setting
        ``cancel`` cancels the gRPC stream — the server stops encoding rows
        (true wire-level early exit)."""
        import grpc

        rpc = self._channel.unary_stream(
            f"/{_SERVICE}/ExecuteTask",
            request_serializer=None, response_deserializer=None,
        )
        held = held_dictionaries()  # advertised, and held for the stream
        req = json.dumps({
            "key": _key_to_obj(key),
            "table_ids": self._shipped_ids.pop(key, []),
            "compression": self._wire_codec(),
            "chunk_rows": int(chunk_rows),
            "have": list(held),
        }).encode()
        stream = rpc(req, timeout=self._deadline(None))
        try:
            try:
                for piece in stream:
                    tag, body = piece[:1], piece[1:]
                    if tag == b"E":
                        raise WorkerError.from_dict(
                            json.loads(body.decode())
                        )
                    if tag == b"H":
                        self._progress_cache[key] = json.loads(
                            body.decode()
                        ).get("progress")
                        continue
                    _, blobs = transport.unpack_frame(body)
                    yield self._decode(blobs["table"], held), len(body)
                    if cancel is not None and cancel.is_set():
                        return
            except grpc.RpcError as e:
                raise _map_rpc_error(e, self.url, key) from e
        finally:
            stream.cancel()

    def _partition_request(self, key: TaskKey, key_names,
                           num_partitions: int, part_lo: int, part_hi: int,
                           per_dest_capacity: int, chunk_rows: int,
                           held: dict) -> dict:
        return {
            "key": _key_to_obj(key),
            "have": list(held),
            "table_ids": self._shipped_ids.pop(key, []),
            "compression": self._wire_codec(),
            "chunk_rows": int(chunk_rows),
            "partitions": {
                "keys": list(key_names), "num": int(num_partitions),
                "lo": int(part_lo), "hi": int(part_hi),
                "per_dest_cap": int(per_dest_capacity),
            },
        }

    def execute_task_partitions(self, key: TaskKey, key_names,
                                num_partitions: int, part_lo: int,
                                part_hi: int, per_dest_capacity: int = 0,
                                chunk_rows: int = 65536, cancel=None):
        """Partition-range multiplex (the reference's RemoteWorkerConnection
        stream carrying a partition range, demuxed per partition,
        `worker_connection_pool.rs:243-308`). Yields
        (partition_id, chunk Table, wire_bytes)."""
        import grpc

        rpc = self._channel.unary_stream(
            f"/{_SERVICE}/ExecuteTask",
            request_serializer=None, response_deserializer=None,
        )
        held = held_dictionaries()  # advertised, and held for the stream
        req = self._partition_request(key, key_names, num_partitions,
                                      part_lo, part_hi, per_dest_capacity,
                                      chunk_rows, held)
        stream = rpc(json.dumps(req).encode(), timeout=self._deadline(None))
        completed = False
        try:
            try:
                for piece in stream:
                    tag, body = piece[:1], piece[1:]
                    if tag == b"E":
                        raise WorkerError.from_dict(
                            json.loads(body.decode())
                        )
                    if tag == b"H":
                        # trails the last chunk: the stream fully drained
                        # and the server's drop-driven release already ran
                        completed = True
                        self._progress_cache[key] = json.loads(
                            body.decode()
                        ).get("progress")
                        continue
                    header, blobs = transport.unpack_frame(body)
                    yield (header["part"],
                           self._decode(blobs["table"], held), len(body))
                    if cancel is not None and cancel.is_set():
                        return
            except grpc.RpcError as e:
                raise _map_rpc_error(e, self.url, key) from e
        finally:
            stream.cancel()
            self._release_incomplete(key, completed)

    def transfer_partitions(self, key: TaskKey, key_names,
                            num_partitions: int, part_lo: int,
                            part_hi: int, per_dest_capacity: int = 0,
                            chunk_rows: int = 65536, cancel=None,
                            wire_compression: str = "auto",
                            shm: bool = True):
        """Streaming DoGet-style pull (the TransferPartitions RPC):
        same yield contract as `execute_task_partitions` —
        (partition_id, chunk Table, wire_bytes) — but the server
        classifies the hop and picks the cheapest plane per chunk:
        S-frames carry a shared-memory segment reference (co-located,
        zero payload bytes on the wire), A-frames adaptive per-column
        compressed payloads, P-frames the plain single-blob fallback.
        A torn segment marks the shm plane broken for this connection
        and raises a RETRYABLE TransportError — the coordinator's
        normal retry re-pulls the partition over the wire path."""
        import os
        import socket

        import grpc

        from datafusion_distributed_tpu_torch.runtime import shm_plane
        from datafusion_distributed_tpu_torch.runtime.codec import (
            decode_table_adaptive,
        )
        from datafusion_distributed_tpu_torch.runtime.telemetry import (
            DEFAULT_REGISTRY,
        )

        wire_ctr = DEFAULT_REGISTRY.counter(
            "dftpu_wire_bytes",
            "Payload bytes that crossed the wire, by data plane",
            labels=("plane",),
        )
        saved_ctr = DEFAULT_REGISTRY.counter(
            "dftpu_wire_bytes_saved",
            "Wire bytes avoided (shm references, compression delta)",
            labels=("plane",),
        )
        rpc = self._channel.unary_stream(
            f"/{_SERVICE}/TransferPartitions",
            request_serializer=None, response_deserializer=None,
        )
        held = held_dictionaries()  # advertised, and held for the stream
        req = self._partition_request(key, key_names, num_partitions,
                                      part_lo, part_hi, per_dest_capacity,
                                      chunk_rows, held)
        req["wire_compression"] = wire_compression
        req["wire_codecs"] = transport.supported_codecs()
        if shm and not self._shm_broken:
            # only the hostname ships: the server reachability-checks
            # its OWN pool dir, the client checks the dir the S-frame
            # names — neither trusts a stale descriptor
            req["shm"] = {"host": socket.gethostname()}
        stream = rpc(json.dumps(req).encode(), timeout=self._deadline(None))
        completed = False
        try:
            try:
                for piece in stream:
                    tag, body = piece[:1], piece[1:]
                    if tag == b"E":
                        raise WorkerError.from_dict(
                            json.loads(body.decode())
                        )
                    if tag == b"H":
                        # trails the last chunk: the stream fully drained
                        # and the server's drop-driven release already ran
                        completed = True
                        self._progress_cache[key] = json.loads(
                            body.decode()
                        ).get("progress")
                        continue
                    if tag == b"S":
                        info = json.loads(body.decode())
                        if self._chaos_tear_next_segment:
                            # chaos kind="segment_lost": tear the segment
                            # between publish and open (the crash window
                            # a dying producer process leaves behind)
                            self._chaos_tear_next_segment = False
                            try:
                                os.unlink(os.path.join(
                                    info["dir"], info["seg"] + ".seg"
                                ))
                            except OSError:
                                pass
                        try:
                            payload, _cap = shm_plane.open_segment_at(
                                info["dir"], info["seg"]
                            )
                        except shm_plane.SegmentError as e:
                            # release what we failed to read (idempotent
                            # on a gone segment), then wire-only for this
                            # connection, retryable for this pull
                            shm_plane.release_at(
                                info["dir"], info["seg"], info["token"]
                            )
                            self._shm_broken = True
                            DEFAULT_REGISTRY.counter(
                                "dftpu_shm_fallbacks",
                                "Shm segments lost; pulls degraded to "
                                "the wire path",
                            ).inc()
                            raise TransportError(
                                f"shm segment lost ({e}); retry pulls "
                                f"over the wire path",
                                worker_url=self.url, task=key,
                            ) from e
                        shm_plane.release_at(
                            info["dir"], info["seg"], info["token"]
                        )
                        # decode WITHOUT capacity — identical to the
                        # P-frame path (the planes' byte-identity
                        # contract); padding is re-derived downstream
                        saved_ctr.inc(int(info["nbytes"]), plane="shm")
                        yield (info["part"], self._decode(payload, held),
                               len(body))
                    elif tag == b"A":
                        header, blobs = transport.unpack_frame(body)
                        wire_ctr.inc(len(body), plane="stream")
                        saved_ctr.inc(
                            transport.frame_saved_bytes(header),
                            plane="stream",
                        )
                        with _on_device(self.device):
                            table = decode_table_adaptive(
                                blobs, header["cols"], device=self.device,
                                held=held)
                        yield header["part"], table, len(body)
                    else:  # b"P"
                        header, blobs = transport.unpack_frame(body)
                        wire_ctr.inc(len(body), plane="stream")
                        saved_ctr.inc(
                            transport.frame_saved_bytes(header),
                            plane="stream",
                        )
                        yield (header["part"],
                               self._decode(blobs["table"], held), len(body))
                    if cancel is not None and cancel.is_set():
                        return
            except grpc.RpcError as e:
                raise _map_rpc_error(e, self.url, key) from e
        finally:
            stream.cancel()
            self._release_incomplete(key, completed)

    def _release_incomplete(self, key: TaskKey, completed: bool) -> None:
        """Best-effort remote release of a partition stream that tore
        down before its trailing H-frame (abandoned LIMIT stream, torn
        segment, retry reroute): the server's drop-driven release only
        fires when EVERY partition is served, so an abandoned remote
        task would otherwise pin its registry entry and shipped slices
        until TTL. The in-process planes get the same sweep from the
        coordinator's `_cleanup_task`; this is its remote face."""
        if completed:
            return
        try:
            self._call("Invalidate", {"key": _key_to_obj(key)})
        except Exception:
            pass  # release must never mask the stream's own error

    def get_info(self) -> dict:
        return self._call("GetInfo", {})

    def get_metrics(self) -> dict:
        """The SERVER worker's telemetry snapshot (the `get_metrics`
        RPC, runtime/telemetry.py wire format) — duck-typed with
        `Worker.get_metrics` so the observability merge runs unchanged
        over either transport."""
        return self._call("GetMetrics", {}).get("metrics", {})

    @property
    def peer_capable(self) -> bool:
        """Asks the SERVER whether it was wired with a peer resolver (the
        client handle cannot know); cached — cluster wiring is static."""
        cached = getattr(self, "_peer_capable_cache", None)
        if cached is None:
            try:
                cached = bool(self.get_info().get("peer_capable", False))
            except Exception:
                cached = False
            self._peer_capable_cache = cached
        return cached

    def release_task(self, key: TaskKey) -> None:
        self._shipped_ids.pop(key, None)
        self._progress_cache.pop(key, None)
        self._call("Invalidate", {"key": _key_to_obj(key)})

    def task_progress(self, key: TaskKey):
        if key in self._progress_cache:
            return self._progress_cache[key]
        return self._call("TaskProgress", {"key": _key_to_obj(key)}).get(
            "progress"
        )


class _NullRegistry:
    """The server invalidates its own registry; the client has nothing to
    clean (Coordinator calls registry.invalidate uniformly)."""

    def invalidate(self, key) -> None:
        pass


# ---------------------------------------------------------------------------
# localhost cluster fixture
# ---------------------------------------------------------------------------


class GrpcPeerResolver:
    """Worker-side channel resolver for the peer data plane: url -> cached
    GrpcWorkerClient (the reference's DefaultChannelResolver channel cache,
    `channel_resolver.rs:113-171`). Shared by all workers in a process;
    its clients decode onto ``device``, the workers' own."""

    def __init__(self, device=None,
                 rpc_timeout_s: Optional[float] = None) -> None:
        self.device = device
        self.rpc_timeout_s = rpc_timeout_s
        self._clients: dict[str, GrpcWorkerClient] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def get_worker(self, url: str) -> GrpcWorkerClient:
        with self._lock:
            if url not in self._clients:
                self._clients[url] = GrpcWorkerClient(
                    url, device=self.device,
                    rpc_timeout_s=self.rpc_timeout_s)
            return self._clients[url]

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


class GrpcCluster:
    """N gRPC workers on random localhost ports, one process — the
    `start_localhost_context` analogue (`src/test_utils/localhost.rs`).
    Every worker, client and peer client uses ``device`` (None: the card).

    Membership is DYNAMIC (the gRPC face of the in-memory
    `DynamicCluster`): `add_worker` spawns a new server and bumps the
    monotonically increasing `membership_epoch`; `remove_worker` stops a
    server NOW (in-flight RPCs fail with UNAVAILABLE -> the retryable
    taxonomy); `drain_worker` keeps the server running for in-flight work
    and peer pulls but drops the url from `get_urls()` so no new tasks
    route to it."""

    def __init__(self, num_workers: int, ttl_seconds: float = 600.0,
                 device=None, rpc_timeout_s: Optional[float] = None):
        self.device = torch.device("cuda" if device is None else device)
        self.rpc_timeout_s = rpc_timeout_s
        self.servers = []  # guarded-by: _lock
        self.urls = []  # guarded-by: _lock
        # test introspection
        self.local_workers: list[Worker] = []  # guarded-by: _lock
        self._clients: dict[str, GrpcWorkerClient] = {}  # guarded-by: _lock
        self._peer_resolver = GrpcPeerResolver(self.device, rpc_timeout_s)
        self._ttl = ttl_seconds
        self._epoch = 0  # guarded-by: _lock
        # url -> (server, Worker)
        self._by_url: dict[str, tuple] = {}  # guarded-by: _lock
        # requested label -> bound url: a membership schedule names a
        # joiner by label ("grpc://w-new") but the real endpoint is the
        # bound localhost port; later leave/drain events for the label
        # must resolve to the server they spawned
        self._aliases: dict[str, str] = {}  # guarded-by: _lock
        self._draining: list[str] = []  # guarded-by: _lock
        self._departed: set = set()  # guarded-by: _lock
        # chaos membership events mutate from worker-call threads while
        # coordinator pool threads read urls/epoch — same guarantee as
        # DynamicCluster's RLock (a reader never sees a torn url-set/epoch
        # pair, concurrent mutations never lose an epoch bump)
        self._lock = threading.RLock()
        for _ in range(num_workers):
            self.add_worker()

    def _resolve(self, url: str) -> str:
        return self._aliases.get(url, url)

    @property
    def membership_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def get_urls(self):
        with self._lock:
            return list(self.urls)

    def get_worker(self, url: str) -> GrpcWorkerClient:
        with self._lock:
            url = self._resolve(url)
            if url in self._departed:
                raise WorkerUnavailableError(
                    f"worker {url} has left the cluster", worker_url=url
                )
            if url not in self._clients:
                self._clients[url] = GrpcWorkerClient(
                    url, device=self.device,
                    rpc_timeout_s=self.rpc_timeout_s)
            return self._clients[url]

    # -- dynamic membership --------------------------------------------------
    def add_worker(self, url: Optional[str] = None) -> str:
        """Spawn + serve a new worker on 127.0.0.1; -> its url. A requested
        ``url`` is only a label — the real endpoint is the bound localhost
        port, and the label resolves to it for later membership calls."""
        i = len(self.local_workers)
        w = Worker(url=url or f"grpc-local-{i}", ttl_seconds=self._ttl,
                   peer_channels=self._peer_resolver, device=self.device)
        server, port = serve_worker(w, host="127.0.0.1")
        real_url = f"grpc://127.0.0.1:{port}"
        w.url = real_url
        with self._lock:
            if url:
                self._aliases[url] = real_url
            self.servers.append(server)
            self.urls.append(real_url)
            self.local_workers.append(w)
            self._by_url[real_url] = (server, w)
            self._departed.discard(real_url)
            self._epoch += 1
        return real_url

    def remove_worker(self, url: str, release: bool = True) -> None:
        """Abrupt leave: stop the server now. ``release`` clears the local
        worker's registry/store the way the dying process would."""
        with self._lock:
            url = self._resolve(url)
            server, w = self._by_url[url]
            if url in self.urls:
                self.urls.remove(url)
            if url in self._draining:
                self._draining.remove(url)
            self._departed.add(url)
            self._epoch += 1
        server.stop(grace=None)
        if release:
            w.registry.clear()
            w.table_store.tables.clear()

    def drain_worker(self, url: str) -> None:
        with self._lock:
            url = self._resolve(url)
            if url not in self.urls:
                return
            self.urls.remove(url)
            self._draining.append(url)
            self._epoch += 1

    def is_departed(self, url: str) -> bool:
        with self._lock:
            return self._resolve(url) in self._departed

    def is_drained(self, url: str) -> bool:
        with self._lock:
            url = self._resolve(url)
            if url not in self._draining:
                return False
            _server, w = self._by_url[url]
        return len(w.registry) == 0 and not w.table_store.tables

    def finish_drains(self) -> list:
        with self._lock:
            draining = list(self._draining)
        removed = [u for u in draining if self.is_drained(u)]
        for u in removed:
            self.remove_worker(u, release=False)
        return removed

    def membership_snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "active": list(self.urls),
                "draining": list(self._draining),
                "departed": sorted(self._departed),
            }

    def shutdown(self) -> None:
        """Stop every server (waiting for each to stop), close every
        client's channel and reclaim every worker's segment directory (the
        backstop for references a dead consumer never released)."""
        with self._lock:
            servers = list(self.servers)
            clients = list(self._clients.values())
            self._clients = {}
            workers = list(self.local_workers)
        for s in servers:
            s.stop(grace=None).wait(timeout=10.0)
        for c in clients:
            c.close()
        self._peer_resolver.close()
        for w in workers:
            w.segment_pool.shutdown()


def start_localhost_cluster(num_workers: int, device=None,
                            rpc_timeout_s: Optional[float] = None
                            ) -> GrpcCluster:
    """``num_workers`` gRPC workers on 127.0.0.1 in this process, every one
    on ``device`` (None: the card; the tests pass "cpu")."""
    return GrpcCluster(num_workers, device=device,
                       rpc_timeout_s=rpc_timeout_s)
