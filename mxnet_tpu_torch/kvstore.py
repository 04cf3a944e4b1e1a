"""KVStore: int/str-keyed parameter synchronization for data parallelism.

Counterpart of ``mxnet_tpu/kvstore.py``, with torch tensors as values:

  'local'/'device'   in-process merge: values pushed as a list are summed
                     on the first one's device, then the updater (or a
                     copy) writes the stored value.
  'dist_sync'        BSP sum across ``torch.distributed`` ranks: every
                     push is summed over the ranks before the updater
                     runs, so every rank's pull sees the same value. One
                     process per rank, joined from the ``MXTPU_COORDINATOR``
                     / ``MXTPU_NUM_WORKERS`` / ``MXTPU_WORKER_RANK``
                     variables (``tools/launch.py``), or by the caller's own
                     ``dist.init_process_group`` before the store is made.
                     ``push_bucketed`` sums a whole gradient dict as ~4 MB
                     slabs (bf16 on the wire where compression is set).
  'dist_async'       update-on-arrival parameter host on the CPU side
                     (``kvstore_async.py``), hosted by rank 0 and found
                     through ``MXTPU_ASYNC_PORT``: workers push and pull at
                     their own pace, the optimizer runs on the host.

``create_group(n)`` builds n in-process handles sharing one BSP server
(:class:`_GroupServer`: accumulate until every worker pushed, run the
updater once, release the pullers), the single-host stand-in for the
reference's ``dmlc_local.py -n N`` harness; run each handle from its own
thread.

The training step's gradient sync does not go through push/pull: ``fit``
calls ``comm`` directly, as the JAX package's train step syncs inside its
compiled program.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .base import MXNetError
from .comm import CompressionSpec
from .comm.allreduce import _all_gather, _row_sum, all_reduce_sum
from .analysis.lockwatch import named_condition, named_lock
from .resilience import chaos
from .resilience.retry import RetryPolicy, retry_call

__all__ = ["KVStore", "create", "create_group", "wrap_np_updater"]


def _unwrap(value):
    """An ``NDArray`` (or a list of them, one a device) as its tensor(s):
    the stores take NDArrays as the JAX package's do, and tensors."""
    from .ndarray import NDArray

    if isinstance(value, NDArray):
        return value.data
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return value


def _write_outs(outs, value: torch.Tensor):
    """Write a pulled ``value`` into ``outs``: a tensor (in place), an
    ``NDArray`` (which rebinds, as its every write does) or a list of
    either, one a device."""
    from .ndarray import NDArray

    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    for o in outs:
        if isinstance(o, NDArray):
            o[:] = value.reshape(o.shape)
        else:
            with torch.no_grad():
                o.copy_(value.reshape(o.shape))


def _to_numpy(value) -> np.ndarray:
    """A tensor's (or array's) values as a host f32 array."""
    value = _unwrap(value)
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32)


class KVStore:
    """Base: single-worker store with local merge semantics."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store: dict = {}
        self._updater = None
        self._compression = None

    def set_gradient_compression(self, compression):
        """Record gradient compression (reference:
        kvstore.set_gradient_compression; accepts ``{'type': '2bit',
        'threshold': 0.5}``, a mode name or a CompressionSpec). An
        in-process store has no wire, so it only records the spec."""
        self._compression = CompressionSpec.resolve(compression)
        return self._compression

    @staticmethod
    def _as_pairs(key, value):
        if isinstance(key, (int, str)):
            return [(key, value)]
        if len(key) != len(value):
            raise MXNetError("key/value list length mismatch")
        return list(zip(key, value))

    @staticmethod
    def _merge(vlist) -> torch.Tensor:
        """Sum a list of per-device tensors on the first one's device
        (reference: MergePushValue)."""
        vlist = _unwrap(vlist)
        if isinstance(vlist, torch.Tensor):
            return vlist
        total = vlist[0]
        for v in vlist[1:]:
            total = total + v.to(total.device)
        return total

    def init(self, key, value):
        for k, v in self._as_pairs(key, value):
            if k in self._store:
                raise MXNetError(f"key {k!r} already initialized")
            if isinstance(v, (list, tuple)):
                v = v[0]
            self._store[k] = _unwrap(v).detach().clone()

    def _reduce(self, merged: torch.Tensor) -> torch.Tensor:
        return merged

    def push(self, key, value, priority=0):
        del priority  # accepted for parity; the caller orders its pushes
        for k, vlist in self._as_pairs(key, value):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            merged = self._reduce(self._merge(vlist))
            with torch.no_grad():
                if self._updater is not None:
                    self._updater(k, merged, self._store[k])
                else:
                    self._store[k].copy_(merged)

    def pull(self, key, out, priority=0):
        del priority
        for k, outs in self._as_pairs(key, out):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            _write_outs(outs, self._store[k])

    def set_updater(self, updater):
        """updater(key, merged_grad, stored_weight) (reference: set_updater)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        from .optimizer import get_updater

        self.set_updater(get_updater(optimizer))

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        pass

    def send_command_to_servers(self, head, body):
        """The reference's server command channel; in-process stores have
        no server, so it does nothing."""
        del head, body


def _local_world() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` where a launcher sets
    it (torchrun), else the ``MXTPU_NUM_WORKERS`` that ``tools/launch.py``
    starts, all on its own host, else the joined world's size, else 1."""
    for name in ("LOCAL_WORLD_SIZE", "MXTPU_NUM_WORKERS"):
        raw = os.environ.get(name)
        if raw:
            return int(raw)
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_rank() -> int:
    """This rank's index on its host, as ``parallel.mesh`` reads it:
    ``LOCAL_RANK``, else the rank (the world's, else the launcher's)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("MXTPU_WORKER_RANK", "0"))


def _dist_backend(ctx=None) -> str:
    """The backend a ``dist_sync`` world joins with: nccl only where every
    rank on the host has a card of its own, else gloo. nccl refuses two
    ranks on one card, so where the host's ranks outnumber its cards (or
    ``ctx`` is a cpu context, or there is no card) the ranks join gloo and
    the exchange goes through pinned host buffers (``comm/allreduce.py``),
    as ranks that share a card must."""
    if ctx is not None and ctx.device_type != "gpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if _local_world() <= torch.cuda.device_count() else "gloo"


def _maybe_init_distributed(backend: str):
    """Join the world the ``MXTPU_*`` variables describe (``tools/launch.py``:
    ``MXTPU_COORDINATOR`` host:port, ``MXTPU_NUM_WORKERS``,
    ``MXTPU_WORKER_RANK``) with ``backend``, and say so in one log line. A
    no-op when the caller already called ``dist.init_process_group``
    (kvstore.py:195-198) or when the variables describe one process.
    Unlike the JAX package, a failed join raises: it does not go on as one
    process."""
    if dist.is_initialized():
        return
    coord = os.environ.get("MXTPU_COORDINATOR")
    nproc = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
    rank = os.environ.get("MXTPU_WORKER_RANK")
    if not coord or nproc <= 1 or rank is None:
        return
    init_method = coord if "://" in coord else f"tcp://{coord}"
    if backend == "nccl":
        # the rank's own card, as parallel.mesh picks it
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nproc, rank=int(rank))
    except (RuntimeError, ValueError) as e:
        raise MXNetError(f"joining the {nproc}-rank world at {init_method} "
                         f"as rank {rank} failed: {e}") from e
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    logging.getLogger(__name__).log(
        logging.WARNING if backend == "gloo" and cards else logging.INFO,
        "mxnet_tpu_torch: rank %s joined the %d-rank world with %s "
        "(%d rank(s) on this host, %d card(s))", rank, nproc, backend,
        _local_world(), cards)


class _DistKVStore(KVStore):
    """'dist_sync': BSP across ranks. push: local merge, then the global sum
    (an all_reduce); every rank's pull then sees the same reduced value, as
    the reference's accumulate-until-N server (kvstore_dist_server.h:164-193)
    without the server hop."""

    def __init__(self, kv_type="dist_sync", backend="gloo"):
        super().__init__(kv_type)
        _maybe_init_distributed(backend)
        self._nproc = dist.get_world_size() if dist.is_initialized() else 1
        self._bucketer = None  # (key tuple, GradBucketer)

    def set_gradient_compression(self, compression):
        """dist_sync's collective sums on the wire, so only a dtype-level
        compression composes with it (bf16, applied by ``push_bucketed``).
        int8/twobit need the decode-accumulate decomposition: use
        ``fit(compression=...)``."""
        spec = CompressionSpec.resolve(compression)
        if spec is not None and spec.mode != "bf16":
            raise MXNetError(
                f"dist_sync supports bf16 wire compression only, got "
                f"{spec.mode!r}; use fit(compression=...) for quantized "
                "gradient sync")
        self._compression = spec
        return spec

    @property
    def rank(self):
        return dist.get_rank() if self._nproc > 1 else 0

    @property
    def num_workers(self):
        return self._nproc

    def _reduce(self, merged):
        if self._nproc == 1:
            return merged
        # accumulate in f32 whatever the value's dtype
        return all_reduce_sum(merged.to(torch.float32)).to(merged.dtype)

    def barrier(self):
        if self._nproc > 1:
            dist.barrier()

    def _bucketer_for(self, arrays: dict):
        sig = tuple(sorted(arrays, key=str))
        if self._bucketer is None or self._bucketer[0] != sig:
            from .comm import GradBucketer

            self._bucketer = (sig, GradBucketer(
                [(k, tuple(arrays[k].shape)) for k in sig]))
        return self._bucketer[1]

    def push_bucketed(self, kvs: dict, priority=0):
        """Push a whole gradient dict as size-capped fused slabs: one
        global sum per ~4 MB bucket instead of one per key (DDP-style).
        ``kvs`` maps key -> tensor or a per-device tensor list (merged
        like ``push``). With bf16 compression set the slab crosses the
        wire as bf16 and is summed in f32 (mxnet_tpu/kvstore.py:312-353)."""
        del priority
        from . import telemetry

        telemetry.counter("kvstore_push_pull_total")
        arrays = {}
        for k, v in kvs.items():
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            arrays[k] = _to_numpy(self._merge(v))
        bucketer = self._bucketer_for(arrays)
        slabs = bucketer.pack(arrays)
        for name, flat in slabs.items():
            slab = torch.from_numpy(flat)
            if self._compression is not None:
                # bf16 on the wire (see the setter), summed in f32
                slab = slab.to(torch.bfloat16)
                slab = _row_sum(_all_gather(slab, None, self._nproc).to(
                    torch.float32)) if self._nproc > 1 else slab.float()
            elif self._nproc > 1:
                slab = all_reduce_sum(slab)
            slabs[name] = slab.numpy()
        for k, v in bucketer.unpack(slabs).items():
            merged = torch.from_numpy(np.ascontiguousarray(v)).to(
                self._store[k].device)
            with torch.no_grad():
                if self._updater is not None:
                    self._updater(k, merged, self._store[k])
                else:
                    self._store[k].copy_(merged)


def wrap_np_updater(updater):
    """Adapt a tensor updater ``updater(key, merged, weight)`` to the
    numpy buffers a server holds: the weight is a tensor sharing the
    stored buffer's memory, so the update writes it in place."""

    def np_updater(key, merged, stored):
        updater(key, torch.from_numpy(np.array(merged, np.float32)),
                torch.from_numpy(stored))

    return np_updater


class _GroupServer:
    """In-process BSP server of an emulated multi-worker group: accumulates
    pushes per key until every worker arrived, runs the updater once, then
    releases the pullers (reference: KVStoreDistServer::DataHandle sync
    path).

    Idempotent against resends: a worker naming its pushes ``(worker,
    seq)`` can resend after a lost ack without double-counting; a
    duplicate waits until the round it already contributed to is released,
    then returns as the original would have. Anonymous pushes accumulate
    everything.

    Membership: ``deregister_worker`` removes a dead or leaving worker (the
    membership epoch bumps and every open round is re-evaluated against the
    smaller world); ``register_worker`` readmits one. Every wait can carry
    a deadline (``op_timeout``, else ``MXNET_TPU_KV_OP_TIMEOUT``; off by
    default): a round stalled past it raises ``MXNetError`` naming the
    presumed dead worker's round instead of hanging."""

    def __init__(self, num_workers, op_timeout=None):
        self.num_workers = num_workers
        if op_timeout is None:
            raw = os.environ.get("MXNET_TPU_KV_OP_TIMEOUT", "").strip()
            op_timeout = float(raw) if raw else 0.0
        self.op_timeout = op_timeout or None  # 0 -> no deadline
        self.membership_epoch = 0
        self.lock = named_lock("kvstore.GroupServer")
        self.cv = named_condition("kvstore.GroupServer.cv", self.lock)
        self.store: dict = {}
        self.updater = None
        self._accum: dict = {}
        self._count: dict = {}
        self._round: dict = {}
        self._contrib: dict = {}  # key -> {worker ids in the open round}
        self._applied: dict = {}  # (key, worker) -> (seq, round applied in)
        self.duplicate_count = 0
        self._replicas: dict = {}  # origin -> (step, payload), newest wins
        self.replica_count = 0
        self.replica_duplicate_count = 0
        self._barrier_count = 0
        self._barrier_round = 0
        self._left: set = set()
        self.wire_bytes_received = 0
        self.raw_bytes_received = 0

    def _timeout(self, what):
        """A stalled round is a presumed dead worker: raise
        ``resilience.elastic.MembershipTimeout`` (an ``MXNetError``)
        carrying the membership epoch, which the elastic layer reads as a
        membership change."""
        from .resilience.elastic import MembershipTimeout

        raise MembershipTimeout(
            f"kvstore {what} stalled past {self.op_timeout}s at membership "
            f"epoch {self.membership_epoch} with {self.num_workers} "
            "worker(s) expected: presumed dead worker; deregister it "
            "(ElasticCoordinator.kill and deregister_worker) and resize",
            membership_epoch=self.membership_epoch)

    def _maybe_release_key_locked(self, key):
        """Release ``key``'s open round once every current member has
        contributed (``>=``: a worker that pushed and then left counts)."""
        if not 0 < self.num_workers <= self._count.get(key, 0):
            return False
        merged = self._accum[key]
        if self.updater is not None:
            self.updater(key, merged, self.store[key])
        else:
            self.store[key] = merged.copy()
        self._count[key] = 0
        self._contrib[key] = set()
        self._round[key] = self._round.get(key, 0) + 1
        self.cv.notify_all()
        return True

    def _maybe_release_barrier_locked(self):
        if not 0 < self.num_workers <= self._barrier_count:
            return False
        self._barrier_count = 0
        self._barrier_round += 1
        self.cv.notify_all()
        return True

    def deregister_worker(self, worker):
        """Remove a dead or leaving worker; open rounds re-evaluate against
        the smaller world. Idempotent; returns the new epoch."""
        with self.cv:
            if worker in self._left or self.num_workers <= 0:
                return self.membership_epoch
            self._left.add(worker)
            self.num_workers -= 1
            self.membership_epoch += 1
            for key in list(self._accum):
                self._maybe_release_key_locked(key)
            self._maybe_release_barrier_locked()
            self.cv.notify_all()
            return self.membership_epoch

    def register_worker(self, worker):
        """Readmit a worker that left (register between rounds, then pull
        and barrier). Idempotent; returns the new epoch."""
        with self.cv:
            if worker not in self._left:
                return self.membership_epoch
            self._left.discard(worker)
            self.num_workers += 1
            self.membership_epoch += 1
            self.cv.notify_all()
            return self.membership_epoch

    def _decode_value(self, key, value):
        """A worker with compression set pushes an ``("enc", spec_args,
        payload)`` envelope: decode it to the stored shape and count the
        wire bytes. Plain arrays pass through."""
        if not (isinstance(value, tuple) and len(value) == 3
                and value[0] == "enc"):
            self.raw_bytes_received += getattr(value, "nbytes", 0)
            self.wire_bytes_received += getattr(value, "nbytes", 0)
            return value
        from .comm import decode_payload, payload_bytes_of

        _, spec_args, payload = value
        self.wire_bytes_received += payload_bytes_of(payload)
        flat = decode_payload(CompressionSpec(*spec_args), payload)
        self.raw_bytes_received += flat.nbytes
        return flat.reshape(self.store[key].shape)

    def init(self, key, value: np.ndarray):
        with self.lock:
            if key not in self.store:
                self.store[key] = np.array(value, np.float32)

    def push(self, key, value, worker=None, seq=None, trace=None):
        """The BSP push; returns True for a duplicate resend (absorbed,
        not counted twice). ``trace`` (``telemetry.trace_ctx()``) makes
        the handling a ``server_span`` of the worker step that caused it,
        when that step is open (mxnet_tpu/kvstore.py:528-551); the time
        waited on the round's other workers is reported apart."""
        if trace is None or trace.get("span_id") is None:
            return self._push(key, value, worker, seq, [0.0])
        from . import telemetry

        t0 = telemetry.hub().now()
        waited = [0.0]
        dedup = self._push(key, value, worker, seq, waited)
        telemetry.emit_server_span(
            "push", trace, t0, dedup=dedup, key=key,
            origin_rank=trace.get("rank", worker), wait_s=waited[0])
        return dedup

    def _push(self, key, value, worker, seq, waited):
        def wait(predicate, what):
            t0 = time.perf_counter()
            ok = self.cv.wait_for(predicate, timeout=self.op_timeout)
            waited[0] += time.perf_counter() - t0
            if not ok:
                self._timeout(what)

        with self.cv:
            value = self._decode_value(key, value)
            my_round = self._round.get(key, 0)
            if worker is not None:
                prev = self._applied.get((key, worker))
                if prev is not None and seq is not None and \
                        prev[0] is not None and seq <= prev[0]:
                    # a resend of a push that already landed: wait for ITS
                    # round, not the open one
                    self.duplicate_count += 1
                    applied_round = prev[1]
                    wait(lambda: self._round.get(key, 0) > applied_round,
                         f"push[{key}] resend round {applied_round}")
                    return True
                contrib = self._contrib.setdefault(key, set())
                if worker in contrib:
                    # a same-round duplicate without a usable seq
                    self.duplicate_count += 1
                    wait(lambda: self._round.get(key, 0) > my_round,
                         f"push[{key}] duplicate round {my_round}")
                    return True
                contrib.add(worker)
                self._applied[(key, worker)] = (seq, my_round)
            if key not in self._accum or self._count.get(key, 0) == 0:
                self._accum[key] = np.array(value, np.float32)
                self._count[key] = 1
            else:
                self._accum[key] += value
                self._count[key] += 1
            if not self._maybe_release_key_locked(key):
                wait(lambda: self._round.get(key, 0) > my_round,
                     f"push[{key}] round {my_round}")
            return False

    def pull(self, key, trace=None) -> np.ndarray:
        if trace is None or trace.get("span_id") is None:
            with self.lock:
                return self.store[key].copy()
        from . import telemetry

        t0 = telemetry.hub().now()
        with self.lock:
            value = self.store[key].copy()
        telemetry.emit_server_span("pull", trace, t0, key=key)
        return value

    def push_replica(self, origin, step, payload):
        """Hold ``origin``'s newest checkpoint snapshot (newest step wins;
        a stale or repeated one is counted, not kept). True when kept."""
        with self.lock:
            prev = self._replicas.get(int(origin))
            if prev is not None and int(step) <= prev[0]:
                self.replica_duplicate_count += 1
                return False
            self._replicas[int(origin)] = (int(step), payload)
            self.replica_count += 1
            return True

    def pull_replica(self, origin):
        with self.lock:
            return self._replicas.get(int(origin))

    def barrier(self):
        """Released when every current member arrived; past the deadline
        this waiter's arrival is withdrawn and it raises."""
        with self.cv:
            my_round = self._barrier_round
            self._barrier_count += 1
            if self._maybe_release_barrier_locked():
                return
            ok = self.cv.wait_for(lambda: self._barrier_round > my_round,
                                  timeout=self.op_timeout)
            if not ok:
                self._barrier_count = max(self._barrier_count - 1, 0)
                self._timeout(f"barrier round {my_round}")


class _GroupWorkerKVStore(KVStore):
    """One worker handle of an emulated dist_sync group (use each from its
    own thread, like one process per worker in the reference harness)."""

    def __init__(self, server: _GroupServer, rank: int):
        super().__init__("dist_sync")
        self._server = server
        self._rank = rank
        self._push_seq: dict = {}  # key -> last sequence number
        self._codec = None         # HostCodec, set by compression
        # resends of a lost push or ack, jittered by rank
        self._retry_policy = RetryPolicy(seed=rank)

    def set_gradient_compression(self, compression):
        spec = super().set_gradient_compression(compression)
        self._codec = None  # rebuilt (fresh residuals) on the next push
        return spec

    def push_replica(self, origin, step, payload):
        return self._server.push_replica(origin, step, payload)

    def pull_replica(self, origin):
        return self._server.pull_replica(origin)

    def compression_stats(self) -> dict:
        """This worker's wire accounting of its compressed pushes."""
        if self._codec is None:
            return {"bytes_raw": 0, "bytes_encoded": 0, "ratio": 1.0}
        return {"bytes_raw": self._codec.bytes_raw,
                "bytes_encoded": self._codec.bytes_encoded,
                "ratio": self._codec.ratio}

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._server.num_workers

    def init(self, key, value):
        for k, v in self._as_pairs(key, value):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if self._rank == 0:  # rank 0 initializes (kvstore_dist.h:49)
                self._server.init(k, _to_numpy(v))
        self.barrier()

    def push(self, key, value, priority=0):
        """Each logical push carries a stable ``(worker, seq)`` identity,
        so a resend cannot count twice at the server. The residual of a
        compressed push is folded in once, at encode time. The worker's
        trace identity rides the push: the server's handling becomes a
        child span of this worker's open step."""
        del priority
        from . import telemetry

        telemetry.counter("kvstore_push_pull_total")
        self._maybe_beacon()
        trace = telemetry.trace_ctx()
        trace["rank"] = self._rank
        for k, vlist in self._as_pairs(key, value):
            value_np = _to_numpy(self._merge(vlist))
            if self._compression is not None:
                from .comm import HostCodec

                if self._codec is None:
                    self._codec = HostCodec(self._compression)
                spec = self._compression
                value_np = ("enc", (spec.mode, spec.threshold, spec.chunk),
                            self._codec.encode(k, value_np.ravel()))
            seq = self._push_seq[k] = self._push_seq.get(k, -1) + 1

            def attempt(k=k, value_np=value_np, seq=seq):
                # the request is lost before the server saw it
                chaos.maybe_raise("group.push.send")
                self._server.push(k, value_np, worker=self._rank, seq=seq,
                                  trace=trace)
                # the ack is lost after the server applied the push: the
                # retry resends the same (worker, seq), which the server
                # absorbs as a duplicate
                chaos.maybe_raise("group.push.ack")

            retry_call(attempt, self._retry_policy, what=f"group.push[{k}]")

    def _maybe_beacon(self):
        """One clock-offset beacon with the server (in one process the
        clocks coincide, but the merge protocol is dist_async's)."""
        if getattr(self, "_beacon_sent", False):
            return
        self._beacon_sent = True
        from . import telemetry

        h = telemetry.hub()
        t_send = h.now()
        telemetry.record_clock_beacon("server", t_send, h.now(), h.now())

    def pull(self, key, out, priority=0):
        del priority
        from . import telemetry

        trace = telemetry.trace_ctx()
        trace["rank"] = self._rank
        for k, outs in self._as_pairs(key, out):
            value = torch.from_numpy(self._server.pull(k, trace=trace))
            _write_outs(outs, value)

    def set_updater(self, updater):
        """The updater runs at the server on its numpy buffers, once a
        round, as the reference runs it on the server."""
        self._server.updater = wrap_np_updater(updater)

    def barrier(self):
        self._server.barrier()


def create(kv_type="local", ctx=None) -> KVStore:
    """Create a KVStore (reference: kvstore.cc:17-49 type-string factory).
    For 'dist_sync', :func:`_dist_backend` picks the backend of a world
    joined from the ``MXTPU_*`` variables: gloo for a cpu ``ctx`` or where
    the host's ranks outnumber its cards, else nccl; the join says which in
    one log line."""
    kv_type = kv_type.lower()
    if kv_type in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStore(kv_type)
    if kv_type in ("device", "local_allreduce_device"):
        # the merge already runs on the device of the first pushed value
        return KVStore(kv_type)
    if kv_type in ("dist", "dist_sync"):
        store = _DistKVStore("dist_sync", _dist_backend(ctx))
    elif kv_type == "dist_async":
        from .kvstore_async import AsyncKVStore

        store = AsyncKVStore()
    else:
        raise MXNetError(f"unknown kvstore type {kv_type!r}")
    if store.num_workers > 1 or store.rank:
        # a distributed store is the process's rank/world authority for
        # telemetry (mxnet_tpu/kvstore.py:805-816)
        from . import telemetry

        telemetry.set_world(store.rank, store.num_workers)
    return store


def create_group(num_workers: int, kv_type="dist_sync", compression=None,
                 op_timeout=None):
    """``num_workers`` worker handles sharing one in-process BSP server
    (the stand-in for the reference's ``dmlc_local.py -n N`` launcher; run
    each handle from its own thread). ``compression`` sets quantized pushes
    on every worker (each keeps its own residuals; the server decodes and
    sums in f32). ``op_timeout`` bounds every wait (default
    ``MXNET_TPU_KV_OP_TIMEOUT``): a stalled round raises instead of
    hanging."""
    if kv_type not in ("dist_sync", "dist"):
        raise MXNetError("create_group supports dist_sync semantics")
    server = _GroupServer(num_workers, op_timeout=op_timeout)
    workers = [_GroupWorkerKVStore(server, r) for r in range(num_workers)]
    if compression is not None:
        for w in workers:
            w.set_gradient_compression(compression)  # mxlint: disable=MX311 - launch config, not mid-run actuation
    return workers
