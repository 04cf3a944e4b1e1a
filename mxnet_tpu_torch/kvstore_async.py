"""``dist_async``: an update-on-arrival parameter host.

Counterpart of ``mxnet_tpu/kvstore_async.py`` (reference:
src/kvstore/kvstore_dist_server.h:194-202): in async mode the server
applies every worker push to the stored weights at once (no
accumulate-until-N), so workers run at their own pace with unbounded
staleness. The host is a small TCP server started by worker rank 0, where
the reference runs its ps-lite servers, and runs on the CPU: an
asynchronous update does not fit a collective. Workers push and pull
numpy buffers over persistent sockets; the optimizer is pickled to the
host (reference: python/mxnet/kvstore.py:231-256) and applied there on
arrival to CPU tensors that share the stored buffers (``wrap_np_updater``).
Launcher ``-s`` server processes retire at import (``kvstore_server.py``).

Wire protocol (one reply per request), each message framed as

    >I header_len | header | >I nbuf | nbuf x ( >Q buf_len | raw bytes )

where ``header`` is a pickle of ``(op, *args)`` in which every numpy array
has been replaced by a ``_TensorRef(index, dtype, shape)`` marker and its
bytes moved to the raw-buffer section: tensors cross the socket as raw
frames (sent from the array's memory, received with one
``np.frombuffer``), never through the pickler. Ops: init, push, pull,
push_many, pull_many, push_pull (apply gradients and return the updated
weights, the trainer's one round trip a step), their compressed forms
push_many_enc and push_pull_enc (bucketed ``HostCodec`` payloads),
set_compression, set_optimizer, replica and replica_pull (checkpoint
snapshots, newest step wins), barrier, leave and join (membership), stats,
stop.

Mutating requests carry ``(rank, seq)``: a request resent after a dead
connection is answered from the host's replay cache, never applied twice,
and a resend racing the original waits for its reply.

The host is found at ``MXTPU_ASYNC_PORT`` on the coordinator's host (the
launcher's OS-assigned port), else at the coordinator's port + 1; a single
process without the launcher's variables hosts it on a loopback port of
its own.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from .kvstore import KVStore, _to_numpy, _write_outs, wrap_np_updater
from .resilience import chaos
from .analysis.lockwatch import named_condition, named_lock

__all__ = ["AsyncKVStore"]

_MAGIC = b"mxtb"  # raw-buffer tensor frames (the JAX package's magic)
_RETRIES = 5      # reconnect-and-resend attempts of a request
# how long the hosting worker's close() waits for the other workers'
# connections to close: the host lives in rank 0's process and must
# outlive their last requests
_HOST_LINGER_S = 300.0


class _TensorRef:
    """What stands in the pickled header where a tensor's bytes were moved
    to the frame's raw-buffer section."""

    __slots__ = ("index", "dtype", "shape")

    def __init__(self, index, dtype, shape):
        self.index, self.dtype, self.shape = index, dtype, shape

    def __getstate__(self):
        return (self.index, self.dtype, self.shape)

    def __setstate__(self, state):
        self.index, self.dtype, self.shape = state


def _extract_tensors(obj, bufs):
    """Replace the ndarrays of ``obj`` (through dicts, lists and tuples)
    with markers, appending their bytes to ``bufs``."""
    if isinstance(obj, np.ndarray):
        ref = _TensorRef(len(bufs), obj.dtype.str, obj.shape)
        bufs.append(np.ascontiguousarray(obj))
        return ref
    if isinstance(obj, dict):
        return {k: _extract_tensors(v, bufs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_extract_tensors(v, bufs) for v in obj)
    return obj


def _restore_tensors(obj, bufs):
    if isinstance(obj, _TensorRef):
        # each buffer is a bytearray of its own: writable, no copy
        return np.frombuffer(bufs[obj.index],
                             dtype=np.dtype(obj.dtype)).reshape(obj.shape)
    if isinstance(obj, dict):
        return {k: _restore_tensors(v, bufs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_restore_tensors(v, bufs) for v in obj)
    return obj


def _encode_msg(obj):
    """A message's frame pieces: the header pickle and the raw buffers."""
    bufs: list = []
    header = pickle.dumps(_extract_tensors(obj, bufs),
                          protocol=pickle.HIGHEST_PROTOCOL)
    pieces = [struct.pack(">I", len(header)), header,
              struct.pack(">I", len(bufs))]
    for b in bufs:
        mv = memoryview(b).cast("B")
        pieces.append(struct.pack(">Q", mv.nbytes))
        pieces.append(mv)
    return pieces


def _send_msg(sock, obj):
    """Send every piece in as few ``sendmsg`` calls as the kernel takes
    (at most 1024 pieces a call), tensors from their own memory."""
    pieces = [memoryview(p).cast("B") for p in _encode_msg(obj)]
    while pieces:
        sent = sock.sendmsg(pieces[:1024])
        while sent:
            if sent >= pieces[0].nbytes:
                sent -= pieces[0].nbytes
                pieces.pop(0)
            else:
                pieces[0] = pieces[0][sent:]
                sent = 0


def _recv_exact(sock, n):
    """Exactly ``n`` bytes into one preallocated writable buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf


def _recv_msg(sock):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    header = pickle.loads(_recv_exact(sock, n))
    (nbuf,) = struct.unpack(">I", _recv_exact(sock, 4))
    bufs = []
    for _ in range(nbuf):
        (blen,) = struct.unpack(">Q", _recv_exact(sock, 8))
        bufs.append(_recv_exact(sock, blen))
    return _restore_tensors(header, bufs)


class _AsyncServer:
    """The parameter host: applies pushes on arrival under one lock (the
    reference serializes its updater calls on one executor thread,
    kvstore_dist_server.h:28-85). One thread a connection."""

    def __init__(self, host, port, num_workers):
        self.num_workers = num_workers
        self.store: dict = {}
        self.updater = None
        self.lock = named_lock("kvstore_async.AsyncServer")
        self.cv = named_condition("kvstore_async.AsyncServer.cv", self.lock)
        self._barrier_count = 0
        self._barrier_round = 0
        # membership: leave/join of a named rank are set operations, and
        # the epoch tags barrier rounds; an opt-in deadline
        # (MXNET_TPU_KV_OP_TIMEOUT) turns a stalled barrier into an error
        self._membership_epoch = 0
        self._members = set(range(num_workers))
        raw = os.environ.get("MXNET_TPU_KV_OP_TIMEOUT", "").strip()
        self._op_timeout = (float(raw) if raw else 0.0) or None
        self._stopped = 0
        self._open = 0  # connections being served
        self._compression = None   # the last spec set (requests carry theirs)
        self._layouts: dict = {}   # layout hash -> bucket layout
        self.wire_bytes_received = 0  # encoded payload bytes accepted
        self.raw_bytes_received = 0   # f32 bytes those payloads replaced
        # push requests applied on arrival: one a push_many / push_pull
        # batch, one a key for the single-key push
        self.update_count = 0
        # (rank) -> (seq, reply) of the last mutating request; reply None
        # while it is being applied
        self._applied: dict = {}
        self.duplicate_count = 0
        self._conn_tls = threading.local()  # per-connection-thread flags
        self._replicas: dict = {}  # origin -> (step, blob), newest wins
        self.replica_count = 0
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(max(8, num_workers * 2))
        self._serve_seq = 0
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="mxtorch-kv-accept",
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                if _recv_exact(conn, 4) != _MAGIC:
                    conn.close()
                    continue
                conn.sendall(_MAGIC)
            except (ConnectionError, OSError):
                conn.close()
                continue
            self._serve_seq += 1
            threading.Thread(target=self._serve, args=(conn,),
                             name=f"mxtorch-kv-serve-{self._serve_seq}",
                             daemon=True).start()

    def _serve(self, conn):
        with self.cv:
            self._open += 1
        try:
            while True:
                msg = _recv_msg(conn)
                try:
                    if self._handle(conn, msg):
                        return
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # noqa: BLE001 - replied, not hung
                    _send_msg(conn, ("err", f"{type(e).__name__}: {e}"))
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()
            with self.cv:
                self._open -= 1
                self.cv.notify_all()

    def wait_idle(self, timeout):
        """Wait until no connection is being served (every worker that
        connected has closed its socket), up to ``timeout`` seconds."""
        with self.cv:
            return self.cv.wait_for(lambda: self._open == 0, timeout)

    def _replay(self, conn, ident):
        """The dedup gate of a mutating request: True when the reply was
        sent again from the cache and the op must not run. Deciding and
        claiming are one step under the lock (the slot is marked ``(seq,
        None)`` before the caller applies), so a resend racing the
        original waits for the original's reply."""
        if ident is None:
            return False
        rank, seq = ident
        with self.cv:
            prev = self._applied.get(rank)
            if prev is None or seq > prev[0]:
                self._applied[rank] = (seq, None)  # claimed: caller applies
                return False
            self.duplicate_count += 1
            self._conn_tls.dedup = True
            if prev[0] == seq and prev[1] is None:
                self.cv.wait_for(
                    lambda: self._applied[rank][0] != seq or
                    self._applied[rank][1] is not None)
            reply = self._applied[rank][1] if self._applied[rank][0] == seq \
                else ("err", f"request (rank {rank}, seq {seq}) superseded")
        _send_msg(conn, reply)
        return True

    def _record(self, ident, reply):
        """Publish the reply of a claimed ``(rank, seq)`` (errors too, so
        no waiter hangs on a claim)."""
        if ident is not None:
            with self.cv:
                self._applied[ident[0]] = (ident[1], reply)
                self.cv.notify_all()

    def _apply_locked(self, kvs):
        """Apply a batch of gradients on arrival (under the lock); the
        error reply names keys never initialized."""
        missing = [k for k in kvs if k not in self.store]
        if missing:
            return ("err", f"keys not initialized: {missing}")
        self.update_count += 1
        for k, value in kvs.items():
            if self.updater is not None:
                self.updater(k, np.asarray(value, np.float32), self.store[k])
            else:
                self.store[k] = np.array(value, np.float32)
        return ("ok",)

    _TRACED_OPS = frozenset({"push", "pull", "push_many", "pull_many",
                             "push_pull", "push_many_enc", "push_pull_enc"})

    def _handle(self, conn, msg):
        """Serve one request; True when the connection is done. A request
        may arrive in a ``("tr", ctx, inner)`` trace envelope
        (``AsyncKVStore._call``): the host adopts the run's trace id and
        emits a ``server_span`` parented under the worker step named in
        ``ctx`` (mxnet_tpu/kvstore_async.py:317-344)."""
        trace = None
        if msg and msg[0] == "tr":
            trace, msg = msg[1], msg[2]
        if trace is None or trace.get("span_id") is None or \
                msg[0] not in self._TRACED_OPS:
            return self._handle_op(conn, msg)
        from . import telemetry

        telemetry.set_trace_id(trace.get("trace_id"), adopt=True)
        t0 = telemetry.hub().now()
        self._conn_tls.dedup = False
        done = self._handle_op(conn, msg)
        telemetry.emit_server_span(
            msg[0], trace, t0,
            dedup=bool(getattr(self._conn_tls, "dedup", False)),
            origin_rank=trace.get("rank", -1))
        return done

    def _handle_op(self, conn, msg):
        op = msg[0]
        if op == "init":
            _, key, value = msg
            with self.lock:  # the first init wins (rank 0 initializes)
                self.store.setdefault(key, np.array(value, np.float32))
            _send_msg(conn, ("ok",))
        elif op == "push":
            key, value = msg[1], msg[2]
            ident = tuple(msg[3:5]) if len(msg) >= 5 else None
            if self._replay(conn, ident):
                return False
            with self.lock:
                reply = self._apply_locked({key: value})
                if reply[0] == "err":
                    reply = ("err", f"key {key!r} not initialized")
            self._record(ident, reply)
            _send_msg(conn, reply)
        elif op == "pull":
            _, key = msg
            with self.lock:
                if key not in self.store:
                    _send_msg(conn, ("err", f"key {key!r} not initialized"))
                    return False
                value = self.store[key].copy()
            # framed and sent outside the lock: other workers' rounds must
            # not wait on this socket
            _send_msg(conn, ("ok", value))
        elif op == "set_compression":
            from .comm import CompressionSpec

            with self.lock:
                self._compression = CompressionSpec(*msg[1]) \
                    if msg[1] is not None else None
            _send_msg(conn, ("ok",))
        elif op in ("push_many_enc", "push_pull_enc"):
            # quantized slabs, decoded with the spec the request carries,
            # unpacked through a layout the client ships once (cached by
            # its hash); a cache miss asks for a resend with the layout.
            # Pulls stay f32 (the reference's 2-bit compression is on the
            # worker-to-server direction only)
            spec_args, lhash, layout, slabs = msg[1:5]
            ident = tuple(msg[5:7]) if len(msg) >= 7 else None
            if self._replay(conn, ident):
                return False
            from .comm import (CompressionSpec, GradBucketer, decode_payload,
                               payload_bytes_of)

            spec = CompressionSpec(*spec_args)
            with self.lock:
                if layout is not None:
                    self._layouts[lhash] = layout
                layout = self._layouts.get(lhash)
            if layout is None:
                reply = ("err", f"unknown bucket layout {lhash}; "
                         "resend with layout")
                self._record(ident, reply)
                _send_msg(conn, reply)
                return False
            flats, wire_b, raw_b = {}, 0, 0
            for name, payload in slabs.items():
                wire_b += payload_bytes_of(payload)
                flats[name] = decode_payload(spec, payload)
                raw_b += flats[name].nbytes
            kvs = GradBucketer.from_layout(layout).unpack(flats)
            with self.lock:
                self.wire_bytes_received += wire_b
                self.raw_bytes_received += raw_b
                reply = self._apply_locked(kvs)
                if reply[0] == "ok" and op == "push_pull_enc":
                    reply = ("ok", {k: self.store[k].copy() for k in kvs})
            self._record(ident, reply)
            _send_msg(conn, reply)
        elif op in ("push_many", "push_pull"):
            kvs = msg[1]  # {key: array}: one round trip a batch
            ident = tuple(msg[2:4]) if len(msg) >= 4 else None
            if self._replay(conn, ident):
                return False
            with self.lock:
                reply = self._apply_locked(kvs)
                if reply[0] == "ok" and op == "push_pull":
                    # copied under the lock, framed and sent after it
                    reply = ("ok", {k: self.store[k].copy() for k in kvs})
            self._record(ident, reply)
            _send_msg(conn, reply)
        elif op == "pull_many":
            _, keys = msg
            with self.lock:
                missing = [k for k in keys if k not in self.store]
                if missing:
                    _send_msg(conn, ("err",
                                     f"keys not initialized: {missing}"))
                    return False
                values = {k: self.store[k].copy() for k in keys}
            _send_msg(conn, ("ok", values))
        elif op == "replica":
            _, origin, step, blob = msg[:4]
            ident = tuple(msg[4:6]) if len(msg) >= 6 else None
            if self._replay(conn, ident):
                return False
            with self.lock:
                prev = self._replicas.get(origin)
                if prev is None or int(step) > prev[0]:
                    self._replicas[origin] = (int(step), blob)
                    self.replica_count += 1
                    reply = ("ok", True)
                else:
                    reply = ("ok", False)  # a stale replica: dropped
            self._record(ident, reply)
            _send_msg(conn, reply)
        elif op == "replica_pull":
            _, origin = msg
            with self.lock:
                ent = self._replicas.get(origin)
            _send_msg(conn, ("ok", ent))
        elif op == "stats":
            with self.lock:
                out = {"update_count": self.update_count,
                       "wire_bytes_received": self.wire_bytes_received,
                       "raw_bytes_received": self.raw_bytes_received,
                       "duplicate_count": self.duplicate_count,
                       "replica_count": self.replica_count,
                       "num_workers": self.num_workers,
                       "keys": len(self.store),
                       "barrier_round": self._barrier_round,
                       "membership_epoch": self._membership_epoch}
            _send_msg(conn, ("ok", out))
        elif op == "set_optimizer":
            _, blob = msg
            from .optimizer import get_updater

            opt = pickle.loads(blob)
            with self.lock:
                self.updater = wrap_np_updater(get_updater(opt))
            _send_msg(conn, ("ok",))
        elif op in ("leave", "join"):
            # membership: the expected world shrinks or grows. A doubled
            # leave would shrink it twice, so these ride the replay cache
            rank = msg[1] if len(msg) > 1 else None
            ident = tuple(msg[2:4]) if len(msg) >= 4 else None
            if self._replay(conn, ident):
                return False
            with self.cv:
                before = self.num_workers
                if rank is None:
                    self.num_workers = max(
                        self.num_workers + (1 if op == "join" else -1), 0)
                else:
                    rank = int(rank)
                    if op == "leave":
                        self._members.discard(rank)
                    else:
                        self._members.add(rank)
                    self.num_workers = len(self._members)
                if self.num_workers != before:
                    self._membership_epoch += 1
                    if op == "leave" and \
                            0 < self.num_workers <= self._barrier_count:
                        self._barrier_count = 0
                        self._barrier_round += 1
                    self.cv.notify_all()
                out = {"num_workers": self.num_workers,
                       "membership_epoch": self._membership_epoch,
                       "rank": rank,
                       "keys": sorted(self.store, key=str)
                       if op == "join" else None}
            reply = ("ok", out)
            self._record(ident, reply)
            _send_msg(conn, reply)
        elif op == "barrier":
            timed_out = False
            with self.cv:
                my_round = self._barrier_round
                epoch0 = self._membership_epoch
                self._barrier_count += 1
                if 0 < self.num_workers <= self._barrier_count:
                    self._barrier_count = 0
                    self._barrier_round += 1
                    self.cv.notify_all()
                elif not self.cv.wait_for(
                        lambda: self._barrier_round > my_round,
                        timeout=self._op_timeout):
                    # withdraw this arrival, so a retry cannot count twice
                    self._barrier_count = max(self._barrier_count - 1, 0)
                    timed_out = True
            if timed_out:
                _send_msg(conn, (
                    "err",
                    f"membership: barrier round {my_round} stalled past "
                    f"{self._op_timeout}s at membership epoch {epoch0} "
                    f"({self.num_workers} worker(s) expected): presumed "
                    "dead worker; shrink the group with the leave op"))
            else:
                _send_msg(conn, ("ok",))
        elif op == "stop":
            with self.lock:
                self._stopped += 1
                done = self._stopped >= self.num_workers
            _send_msg(conn, ("ok",))
            if done:
                self._srv.close()
            return True
        else:
            _send_msg(conn, ("err", f"unknown op {op!r}"))
        return False


class AsyncKVStore(KVStore):
    """The worker handle of ``create('dist_async')``. Rank and world come
    from the launcher's ``MXTPU_WORKER_RANK`` / ``MXTPU_NUM_WORKERS``; the
    async path needs no ``torch.distributed`` group, only the host's
    socket."""

    def __init__(self):
        super().__init__("dist_async")
        self._rank = int(os.environ.get("MXTPU_WORKER_RANK", "0"))
        self._nproc = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
        host, port = self._server_addr()
        self._host, self._port = host, port
        self._server = None
        if self._rank == 0:
            self._server = _AsyncServer(host, port, self._nproc)
        self._sock = self._connect(host, port)
        self._lock = named_lock("kvstore_async.AsyncKVStore")
        self._next_seq = 0  # identity of mutating requests
        self._rpc_timeout = float(
            os.environ.get("MXNET_TPU_RPC_TIMEOUT", "30"))
        self._codec = None         # HostCodec of compressed pushes
        self._bucketer = None      # (key tuple, bucketer, layout, hash)
        self._layouts_sent: set = set()  # layout hashes the host holds
        self._stale_round = None   # the push_pull in flight (stale sync)
        self._stale_pool = None    # one background pusher thread
        self._closed = False

    def _server_addr(self):
        coord = os.environ.get("MXTPU_COORDINATOR")
        async_port = os.environ.get("MXTPU_ASYNC_PORT")
        if coord:
            scheme, _, rest = coord.rpartition("://")
            if scheme in ("", "tcp"):
                host, port = rest.rsplit(":", 1)
                if async_port:  # the launcher's OS-assigned port
                    return host, int(async_port)
                return host, int(port) + 1
            if async_port:  # a file:// rendezvous: the host is this one
                return "127.0.0.1", int(async_port)
            raise MXNetError(f"dist_async: MXTPU_COORDINATOR={coord!r} "
                             "names no host; set MXTPU_ASYNC_PORT")
        if self._nproc != 1:
            raise MXNetError(
                "dist_async needs the launcher environment "
                "(tools/launch.py sets MXTPU_COORDINATOR)")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return "127.0.0.1", s.getsockname()[1]

    def _connect(self, host, port, timeout=60.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(_MAGIC)
                if _recv_exact(sock, 4) == _MAGIC:
                    sock.settimeout(None)
                    return sock
                sock.close()
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise MXNetError(f"dist_async: cannot reach the parameter "
                                 f"host at {host}:{port}")
            time.sleep(0.2)

    def _call(self, *msg, mutating=False, retry=True, timeout="default"):
        """One request and its reply. A dead or timed-out socket is closed
        and the request resent on a new connection (up to ``_RETRIES``
        times, with backoff); a mutating request carries ``(rank, seq)``,
        so the host answers a resend of an applied request from its
        cache. Barriers and stop are counted on arrival and never
        resent."""
        if timeout == "default":
            timeout = self._rpc_timeout
        with self._lock:
            if mutating:
                msg = msg + (self._rank, self._next_seq)
                self._next_seq += 1
            # trace envelope: the host parents its handling span under
            # this worker's open step; a resend carries the same context
            from . import telemetry

            ctx = telemetry.trace_ctx()
            ctx["rank"] = self._rank
            msg = ("tr", ctx, msg)
            for attempt in range(_RETRIES if retry else 1):
                try:
                    if self._sock is None:
                        self._sock = self._connect(self._host, self._port)
                    if chaos.fires("async.call"):
                        # the connection dies mid-request: the send below
                        # fails, and the loop reconnects and resends
                        self._sock.close()
                    self._sock.settimeout(timeout)
                    _send_msg(self._sock, msg)
                    reply = _recv_msg(self._sock)
                    self._sock.settimeout(None)
                    break
                except (ConnectionError, OSError):
                    # the stream's state is unknown: never reuse the socket
                    if self._sock is not None:
                        self._sock.close()
                    self._sock = None
                    if attempt + 1 >= (_RETRIES if retry else 1):
                        raise MXNetError(
                            f"dist_async.{msg[0]}: the parameter host did "
                            "not answer") from None
                    time.sleep(0.05 * 2 ** attempt)
        if reply[0] != "ok":
            raise MXNetError(f"dist_async server: {reply[1]}")
        return reply[1] if len(reply) > 1 else None

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def init(self, key, value):
        for k, v in self._as_pairs(key, value):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if self._rank == 0:
                self._call("init", k, _to_numpy(v))
        self.barrier()

    def push(self, key, value, priority=0):
        del priority
        for k, vlist in self._as_pairs(key, value):
            self._call("push", k, _to_numpy(self._merge(vlist)),
                       mutating=True)

    def pull(self, key, out, priority=0):
        del priority
        for k, outs in self._as_pairs(key, out):
            _write_outs(outs, torch.from_numpy(self._call("pull", k)))

    def push_replica(self, origin, step, payload):
        """Ship ``origin``'s step-``step`` snapshot (any picklable tree) to
        the host's replica slot; True when the host kept it (newest step
        wins)."""
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        return self._call("replica", int(origin), int(step), blob,
                          mutating=True)

    def pull_replica(self, origin):
        """``(step, payload)`` of ``origin``'s newest replica, or None."""
        ent = self._call("replica_pull", int(origin))
        if ent is None:
            return None
        step, blob = ent
        return int(step), pickle.loads(blob)

    def set_gradient_compression(self, compression):
        """Quantized, bucketed batch pushes: gradient dicts of
        ``push_many`` / ``push_pull`` are fused into ~4 MB slabs, encoded
        by a ``HostCodec`` (lossy modes with error feedback on this side)
        and decoded on the host before the updater runs; pulls stay f32.
        The single-key ``push`` stays uncompressed."""
        from .comm import CompressionSpec, HostCodec

        spec = CompressionSpec.resolve(compression)
        # under the socket's lock: a stale round's pusher thread encodes
        # with this state (_call_enc) while the main thread may reset it
        with self._lock:
            self._compression = spec
            self._codec = HostCodec(spec) if spec is not None else None
            self._bucketer = None
            self._layouts_sent = set()
        self._call("set_compression",
                   None if spec is None
                   else (spec.mode, spec.threshold, spec.chunk))
        return spec

    def _encode_slabs(self, kvs: dict):
        import hashlib

        from .comm import GradBucketer, HostCodec

        sig = tuple(sorted(kvs, key=str))
        if self._bucketer is None or self._bucketer[0] != sig:
            bucketer = GradBucketer(
                [(k, tuple(np.asarray(kvs[k]).shape)) for k in sig])
            layout = bucketer.layout()
            lhash = hashlib.sha1(pickle.dumps(layout)).hexdigest()[:16]
            self._bucketer = (sig, bucketer, layout, lhash)
            # a new layout orphans the residuals: each compensates only
            # the slab it was computed against
            self._codec = HostCodec(self._compression)
        _, bucketer, layout, lhash = self._bucketer
        flats = bucketer.pack({k: np.asarray(v, np.float32)
                               for k, v in kvs.items()})
        slabs = {name: self._codec.encode(name, flat)
                 for name, flat in flats.items()}
        return lhash, layout, slabs

    def _call_enc(self, op, kvs):
        """One compressed batch push. The layout ships once a bucketer;
        after that only its hash. On a host cache miss the same slabs are
        resent with the layout (not encoded again: the residual already
        moved)."""
        with self._lock:  # the encoding state, as set_gradient_compression
            spec = self._compression
            spec_args = (spec.mode, spec.threshold, spec.chunk)
            lhash, layout, slabs = self._encode_slabs(kvs)
            send_layout = layout if lhash not in self._layouts_sent else None
        try:
            out = self._call(op, spec_args, lhash, send_layout, slabs,
                             mutating=True)
        except MXNetError as e:
            if "unknown bucket layout" not in str(e) or \
                    send_layout is not None:
                raise
            with self._lock:
                self._layouts_sent.discard(lhash)
            out = self._call(op, spec_args, lhash, layout, slabs,
                             mutating=True)
        with self._lock:
            self._layouts_sent.add(lhash)
        return out

    def push_many(self, kvs: dict, priority=0):
        """Push ``{key: gradient}`` in one round trip."""
        del priority
        if self._codec is not None:
            self._call_enc("push_many_enc", kvs)
            return
        self._call("push_many", {k: _to_numpy(v) for k, v in kvs.items()},
                   mutating=True)

    def pull_many(self, keys, priority=0) -> dict:
        """The current values of ``keys`` in one round trip."""
        del priority
        return self._call("pull_many", list(keys))

    def push_pull(self, kvs: dict, priority=0) -> dict:
        """Apply gradients and return the updated weights in one round
        trip: a trainer's whole sync with the host a step. With
        compression set the gradients travel quantized and bucketed."""
        del priority
        if self._codec is not None:
            return self._call_enc("push_pull_enc", kvs)
        return self._call("push_pull",
                          {k: _to_numpy(v) for k, v in kvs.items()},
                          mutating=True)

    # -- stale sync: the next step computes while this one's push travels --
    def _submit_stale(self, kvs):
        from concurrent.futures import ThreadPoolExecutor

        if self._stale_pool is None:
            # one background pusher: rounds stay in order, and the socket
            # lock orders it against the foreground's requests
            self._stale_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mxtorch-kv-stale-push")

        return self._stale_pool.submit(self.push_pull, kvs)

    def push_pull_stale(self, kvs: dict) -> dict:
        """The pipelined sync of ``overlap=`` on dist_async: this step's
        gradients go to the host from a background thread while the next
        step computes, and the weights returned are the previous round's
        result, one round stale (only one round is ever in flight). The
        first call pulls the current weights. Drain with
        :meth:`flush_stale` before anything reads weights as truth."""
        prev, self._stale_round = self._stale_round, None
        snap = {k: _to_numpy(v).copy() for k, v in kvs.items()}
        out = self.pull_many(list(snap)) if prev is None else prev.result()
        self._stale_round = self._submit_stale(snap)
        return out

    def flush_stale(self, keys) -> dict:
        """Wait out the round in flight (its push must land) and pull the
        current values of ``keys``."""
        fut, self._stale_round = self._stale_round, None
        if fut is not None:
            fut.result()
        return self.pull_many(list(keys))

    def compression_stats(self) -> dict:
        """This worker's wire accounting of its compressed pushes."""
        if self._codec is None:
            return {"bytes_raw": 0, "bytes_encoded": 0, "ratio": 1.0}
        return {"bytes_raw": self._codec.bytes_raw,
                "bytes_encoded": self._codec.bytes_encoded,
                "ratio": self._codec.ratio}

    def set_updater(self, updater):
        raise MXNetError(
            "dist_async runs the updater on the parameter host; ship the "
            "optimizer with set_optimizer() (reference: pickled-optimizer "
            "transport, python/mxnet/kvstore.py:231-256)")

    def set_optimizer(self, optimizer):
        self._call("set_optimizer",
                   pickle.dumps(optimizer, protocol=pickle.HIGHEST_PROTOCOL))

    def barrier(self):
        # counted on arrival, so never resent and without a client
        # deadline: the host bounds the round (MXNET_TPU_KV_OP_TIMEOUT)
        # and answers a stalled one with a membership error, raised here
        # as MembershipTimeout, which the elastic layer reads as a dead
        # worker
        try:
            self._call("barrier", retry=False, timeout=None)
        except MXNetError as e:
            if "membership:" not in str(e):
                raise
            from .resilience.elastic import MembershipTimeout

            raise MembershipTimeout(str(e)) from None

    def leave_group(self, rank=None):
        """Tell the host a worker leaves (this one, or a dead one by rank):
        the expected world shrinks once however many report it. Returns
        ``{num_workers, membership_epoch, ...}``."""
        return self._call("leave",
                          self._rank if rank is None else int(rank),
                          mutating=True)

    def rejoin_group(self, rank=None):
        """Grow the expected world again; returns ``{num_workers,
        membership_epoch, keys}``: pull the keys, then barrier back in."""
        return self._call("join",
                          self._rank if rank is None else int(rank),
                          mutating=True)

    def stats(self) -> dict:
        """The host's counters: ``update_count`` (push requests applied:
        one a batch, one a key for the single-key push),
        ``duplicate_count``, wire and raw bytes received, membership."""
        return self._call("stats")

    def close(self):
        """Drain a stale round, tell the host this worker stops, close the
        socket. The host stops listening once every worker stopped; the
        worker that hosts it waits until every other worker's connection
        has closed (up to ``_HOST_LINGER_S``), so that its process does not
        end while another worker still waits on a reply."""
        if self._closed:
            return
        self._closed = True
        if self._stale_pool is not None:
            self._stale_pool.shutdown(wait=True)
        try:
            self._call("stop", retry=False, timeout=5.0)
        except MXNetError:
            pass
        if self._sock is not None:
            self._sock.close()
        if self._server is not None:
            self._server.wait_idle(_HOST_LINGER_S)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
