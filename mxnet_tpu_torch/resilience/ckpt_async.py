"""The asynchronous checkpoint plane: snapshot, background writer, peers.

Counterpart of ``mxnet_tpu/resilience/ckpt_async.py``. A checkpoint at a
step boundary is split in two:

- T0, :func:`capture_snapshot`: one blocking device-to-host copy of the
  whole training state, the only stall the step loop sees;
- T2, :class:`AsyncCheckpointWriter`: a thread (``mx-ckpt-writer``) drains
  the snapshots through :func:`..utils.checkpoint.save_sharded` and prunes
  old steps. Its queue is bounded and drops the oldest pending snapshot
  first (the freshest state wins); a failed write is counted and logged,
  never raised into training.

:class:`ReplicaStore` is T1, the in-process model of the peer tier: each
rank's newest snapshot held in its neighbour's memory. :func:`save_now` is
the blocking save through the same format.

The JAX package's telemetry counters (``ckpt_*``, the ``checkpoint_save``
phase, a flight dump on a failed write), lockwatch-named locks and the
``ckpt.async_write`` chaos site (a background write that fails) are
here.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..utils import checkpoint as ckpt_mod
from ..analysis.lockwatch import named_condition, named_lock

__all__ = ["Snapshot", "capture_snapshot", "AsyncCheckpointWriter",
           "ReplicaStore", "save_now", "resolve_every", "resolve_keep"]

_WRITER_THREAD = "mx-ckpt-writer"


def resolve_every(arg=None):
    """Checkpoint cadence in optimizer steps: the ``fit`` argument, else
    ``MXNET_TPU_CKPT_STEPS``, else None (epoch-granular only)."""
    if arg is not None:
        return max(1, int(arg))
    env = os.environ.get("MXNET_TPU_CKPT_STEPS", "").strip()
    if env:
        return max(1, int(env))
    return None


def resolve_keep(arg=None):
    """Steps the disk tier keeps: the argument, else
    ``MXNET_TPU_CKPT_KEEP``, else 3. 0 disables pruning."""
    if arg is not None:
        return int(arg)
    return int(os.environ.get("MXNET_TPU_CKPT_KEEP", "3"))


def resolve_queue_depth(arg=None):
    """The writer's queue depth: the argument, else
    ``MXNET_TPU_CKPT_QUEUE``, else 2 (one draining, one pending)."""
    if arg is not None:
        return max(1, int(arg))
    return max(1, int(os.environ.get("MXNET_TPU_CKPT_QUEUE", "2")))


class Snapshot:
    """A host copy of one step's training state. ``state`` mirrors the
    disk layout: ``{"params", "aux"?, "opt"? (flat leaves), "comm"?}``, all
    numpy; ``meta`` is the metadata dict (step, epoch, batches_done,
    rng_state, num_update, ...)."""

    __slots__ = ("step", "state", "meta", "symbol")

    def __init__(self, step, state, meta, symbol=None):
        self.step = int(step)
        self.state = state
        self.meta = dict(meta or {})
        self.symbol = symbol


def _to_host(values):
    """numpy copies of tensors. Device tensors go through one pinned
    buffer each with ``non_blocking`` copies and a single synchronize, so
    the stall is one wait for all of them."""
    out, pending = {}, []
    for k, v in values.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v.detach(), non_blocking=True)
            pending.append((k, host))
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().numpy().copy()
        else:
            out[k] = np.array(v)
    if pending:
        torch.cuda.synchronize()
        out.update((k, host.numpy()) for k, host in pending)
    return out


def capture_snapshot(step, params, aux=None, opt_state=None,
                     comm_state=None, meta=None, symbol=None):
    """The T0 stall: one blocking device-to-host copy of the training
    state at a step boundary, as a :class:`Snapshot`. ``opt_state`` is the
    flat list of optimizer-state leaves. It runs in the ``checkpoint_save``
    phase, so the stall prices into the checkpoint badput bucket."""
    from .. import telemetry

    with telemetry.phase("checkpoint_save"):
        return _capture(step, params, aux, opt_state, comm_state, meta,
                        symbol)


def _capture(step, params, aux, opt_state, comm_state, meta, symbol):
    groups = {"params": dict(params)}
    if aux:
        groups["aux"] = dict(aux)
    if opt_state is not None:
        groups["opt"] = {str(i): v for i, v in enumerate(opt_state)}
    if comm_state is not None:
        groups["comm"] = dict(comm_state)
    flat = {(g, k): v for g, vals in groups.items() for k, v in vals.items()}
    host = _to_host(flat)
    state = {g: {k: host[(g, k)] for k in vals} for g, vals in groups.items()}
    if "opt" in state:
        state["opt"] = [state["opt"][str(i)] for i in range(len(opt_state))]
    return Snapshot(step, state, meta, symbol=symbol)


class AsyncCheckpointWriter:
    """A thread that writes submitted snapshots to the disk tier.

    - ``submit`` never blocks: with the queue full, the oldest pending
      snapshot is dropped (``dropped``);
    - a failed write is counted (``failures``) and logged, never raised;
    - after each write the retention pruner keeps ``keep_last_k`` steps.
    """

    def __init__(self, directory, queue_depth=None, keep_last_k=None,
                 logger=None):
        self.directory = os.path.abspath(os.fspath(directory))
        self.queue_depth = resolve_queue_depth(queue_depth)
        self.keep_last_k = resolve_keep(keep_last_k)
        self.logger = logger or logging.getLogger(__name__)
        self.lock = named_lock("ckpt_async.AsyncCheckpointWriter")
        self.cv = named_condition("ckpt_async.AsyncCheckpointWriter.cv",
                                  self.lock)
        self._pending: deque = deque()
        self._inflight = None
        self._closed = False
        self._last_durable_step = None
        self.submitted = self.written = self.dropped = self.failures = 0
        self.write_seconds = 0.0  # the thread's time in writes
        self._thread = threading.Thread(target=self._run, name=_WRITER_THREAD,
                                        daemon=True)
        self._thread.start()

    def submit(self, snap: Snapshot):
        """Queue a snapshot; False once the writer is closed."""
        from .. import telemetry

        with self.lock:
            if self._closed:
                return False
            while len(self._pending) >= self.queue_depth:
                victim = self._pending.popleft()
                self.dropped += 1
                telemetry.counter("ckpt_snapshots_dropped_total")
                self.logger.warning(
                    "ckpt_async: queue full, dropped pending snapshot for "
                    "step %d (depth %d)", victim.step, self.queue_depth)
            self._pending.append(snap)
            self.submitted += 1
            depth = len(self._pending)
            self.cv.notify_all()
        telemetry.gauge("ckpt_queue_depth", float(depth))
        return True

    def note_step(self, step):
        """Publish staleness: how many optimizer steps the newest durable
        checkpoint trails the live run (``ckpt_snapshot_age_steps``)."""
        from .. import telemetry

        with self.lock:
            last = self._last_durable_step
        if last is not None:
            telemetry.gauge("ckpt_snapshot_age_steps",
                            float(max(0, int(step) - last)))

    def flush(self, timeout=60.0):
        """Wait until every queued snapshot is written; True when the queue
        drained within ``timeout`` seconds."""
        with self.lock:
            deadline = time.monotonic() + timeout
            while self._pending or self._inflight is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cv.wait(timeout=remaining)
        return True

    def close(self, timeout=60.0):
        """Drain the queue, then stop the thread."""
        self.flush(timeout=timeout)
        with self.lock:
            self._closed = True
            self.cv.notify_all()
        self._thread.join(timeout=timeout)

    @property
    def last_durable_step(self):
        with self.lock:
            return self._last_durable_step

    def _run(self):
        from .. import telemetry

        while True:
            with self.lock:
                while not self._pending and not self._closed:
                    self.cv.wait()
                if not self._pending and self._closed:
                    return
                snap = self._pending.popleft()
                self._inflight = snap
                depth = len(self._pending)
            telemetry.gauge("ckpt_queue_depth", float(depth))
            t0 = time.perf_counter()
            try:
                self._write(snap)
                with self.lock:
                    self.written += 1
                    self._last_durable_step = snap.step
            except Exception as exc:  # noqa: BLE001 - never into training
                with self.lock:
                    self.failures += 1
                telemetry.counter("ckpt_write_failures_total")
                telemetry.emit("checkpoint", step=snap.step, seconds=0.0,
                               tier="t0",
                               error=f"{type(exc).__name__}: {exc}")
                self.logger.warning(
                    "ckpt_async: background write for step %d failed: %s",
                    snap.step, exc)
                telemetry.flight.auto_dump("checkpoint")
            finally:
                with self.lock:
                    self.write_seconds += time.perf_counter() - t0  # mxlint: disable=MX306 - host file writes of a host snapshot
                    self._inflight = None
                    self.cv.notify_all()

    def _write(self, snap: Snapshot):
        from . import chaos

        if chaos.fires("ckpt.async_write"):
            raise OSError("chaos: async checkpoint write lost")
        ckpt_mod.save_sharded(
            self.directory, snap.step, snap.state.get("params", {}),
            aux=snap.state.get("aux"), symbol=snap.symbol,
            extra_meta=snap.meta, opt_state=snap.state.get("opt"),
            comm_state=snap.state.get("comm"), tier="t0")
        if self.keep_last_k > 0:
            ckpt_mod.prune_steps(self.directory, self.keep_last_k)


class ReplicaStore:
    """T1 in one process: rank r's newest snapshot is held by rank
    ``(r + 1) % world``. ``replicate`` keeps one snapshot per origin and
    drops a stale or repeated one (step <= the stored step); ``restore``
    returns the freshest snapshot whose holder is alive; ``drop_rank``
    forgets what a departed rank held."""

    def __init__(self, world_size):
        self.world_size = int(world_size)
        self.lock = named_lock("ckpt_async.ReplicaStore")
        self._entries = {}  # origin rank -> {"seq", "holder", "snap"}
        self.duplicate_count = 0

    def holder_of(self, rank):
        return (int(rank) + 1) % self.world_size if self.world_size > 1 \
            else int(rank)

    def replicate(self, rank, snap: Snapshot):
        from .. import telemetry

        rank = int(rank)
        with self.lock:
            ent = self._entries.get(rank)
            if ent is not None and snap.step <= ent["seq"]:
                self.duplicate_count += 1
                return False
            self._entries[rank] = {"seq": snap.step,
                                   "holder": self.holder_of(rank),
                                   "snap": snap}
        telemetry.counter("ckpt_replicas_total")
        return True

    def restore(self, alive=None):
        alive_set = None if alive is None else {int(r) for r in alive}
        best = None
        with self.lock:
            for ent in self._entries.values():
                if alive_set is not None and ent["holder"] not in alive_set:
                    continue
                if best is None or ent["seq"] > best["seq"]:
                    best = ent
        return None if best is None else best["snap"]

    def drop_rank(self, rank):
        rank = int(rank)
        with self.lock:
            self._entries.pop(rank, None)
            for origin in [o for o, e in self._entries.items()
                           if e["holder"] == rank]:
                del self._entries[origin]


def save_now(directory, step, params, aux=None, symbol=None,
             extra_meta=None, opt_state=None, comm_state=None, tier="t2",
             keep=None):
    """The blocking save through the same format; ``keep`` > 0 prunes to
    that many steps after it."""
    out = ckpt_mod.save_sharded(
        directory, step, params, aux=aux, symbol=symbol,
        extra_meta=extra_meta, opt_state=opt_state, comm_state=comm_state,
        tier=tier)
    if keep is not None and keep > 0:
        ckpt_mod.prune_steps(directory, keep)
    return out
