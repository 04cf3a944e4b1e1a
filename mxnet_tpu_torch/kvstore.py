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

The training step's gradient sync does not go through push/pull: ``fit``
calls ``comm.error_feedback_allreduce`` directly, as the JAX package's
train step syncs inside its compiled program. ``dist_async``, the
in-process ``create_group`` harness, ``push_bucketed`` and the host codec
transports are not ported yet and raise (ROADMAP A4).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .base import MXNetError
from .comm import CompressionSpec
from .comm.allreduce import all_reduce_sum

__all__ = ["KVStore", "create", "create_group"]

_LATER = "ROADMAP A4 (left from slice 4: kvstore_async.py, kvstore_server.py)"


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
            self._store[k] = v.detach().clone()

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
            if isinstance(outs, torch.Tensor):
                outs = [outs]
            for o in outs:
                with torch.no_grad():
                    o.copy_(self._store[k])

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

    def push_bucketed(self, kvs: dict, priority=0):
        raise NotImplementedError(f"KVStore.push_bucketed is not ported yet: "
                                  f"{_LATER}")


def _maybe_init_distributed(backend: str):
    """Join the world the ``MXTPU_*`` variables describe (``tools/launch.py``:
    ``MXTPU_COORDINATOR`` host:port, ``MXTPU_NUM_WORKERS``,
    ``MXTPU_WORKER_RANK``) with ``backend``. A no-op when the caller already
    called ``dist.init_process_group`` (kvstore.py:195-198) or when the
    variables describe one process. Unlike the JAX package, a failed join
    raises: it does not go on as one process."""
    if dist.is_initialized():
        return
    coord = os.environ.get("MXTPU_COORDINATOR")
    nproc = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
    rank = os.environ.get("MXTPU_WORKER_RANK")
    if not coord or nproc <= 1 or rank is None:
        return
    init_method = coord if "://" in coord else f"tcp://{coord}"
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nproc, rank=int(rank))
    except (RuntimeError, ValueError) as e:
        raise MXNetError(f"joining the {nproc}-rank world at {init_method} "
                         f"as rank {rank} failed: {e}") from e


class _DistKVStore(KVStore):
    """'dist_sync': BSP across ranks. push: local merge, then the global sum
    (an all_reduce); every rank's pull then sees the same reduced value, as
    the reference's accumulate-until-N server (kvstore_dist_server.h:164-193)
    without the server hop."""

    def __init__(self, kv_type="dist_sync", backend="gloo"):
        super().__init__(kv_type)
        _maybe_init_distributed(backend)
        self._nproc = dist.get_world_size() if dist.is_initialized() else 1

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


def create(kv_type="local", ctx=None) -> KVStore:
    """Create a KVStore (reference: kvstore.cc:17-49 type-string factory).
    For 'dist_sync', ``ctx`` picks the backend of a world joined from the
    ``MXTPU_*`` variables: nccl for a gpu context, gloo for a cpu one (the
    default: nccl where CUDA is available)."""
    kv_type = kv_type.lower()
    if kv_type in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStore(kv_type)
    if kv_type in ("device", "local_allreduce_device"):
        # the merge already runs on the device of the first pushed value
        return KVStore(kv_type)
    if kv_type in ("dist", "dist_sync"):
        on_gpu = (ctx.device_type == "gpu") if ctx is not None \
            else torch.cuda.is_available()
        return _DistKVStore("dist_sync", "nccl" if on_gpu else "gloo")
    if kv_type == "dist_async":
        raise NotImplementedError(f"kvstore 'dist_async' is not ported yet: "
                                  f"{_LATER}")
    raise MXNetError(f"unknown kvstore type {kv_type!r}")


def create_group(num_workers: int, kv_type="dist_sync", compression=None,
                 op_timeout=None):
    """The JAX package's in-process N-worker harness; here each worker is a
    process of its own (``create('dist_sync')``)."""
    raise NotImplementedError(f"kvstore.create_group is not ported yet: "
                              f"{_LATER}")
