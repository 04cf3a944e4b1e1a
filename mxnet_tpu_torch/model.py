"""FeedForward: the estimator-style trainer, on one device, or on each rank
of a data-parallel world.

Counterpart of the single-device and multi-process paths of
``mxnet_tpu/model.py``:
``FeedForward(symbol, ctx, num_epoch, optimizer, initializer, ...)`` with
``fit / predict / score / save / load / create``, and the checkpoint pair
``prefix-symbol.json`` + ``prefix-%04d.params`` with its ``.crc32``
sidecars, in the JAX package's format, so either package loads the other's
checkpoints.

One training step is the JAX package's fused step taken apart: the graph's
training forward on the device, the gradient of the sum of the heads by
autograd (loss heads inject their own gradient and ignore the seed), then
``optimizer.apply`` under ``torch.no_grad()``. With ``optimizer="adam"``
and ``fused=True`` the update is one launch of the ``fused_adam`` kernel.
The learning rate is taken before ``num_update`` is set, in the JAX
package's order (``model.py:2159-2161``), and ``rescale_grad`` is
``1/batch_size``. Metrics accumulate on the device and are pulled once per
epoch, unless a ``batch_end_callback`` needs them after every batch.

A ctx list of several devices trains them as replicas of one process, the
JAX package's single-process ``dp`` mesh (``_ReplicaState``): each replica
steps on its equal block of each batch's rows with its own parameters,
auxiliary and optimizer state, and the replicas' gradients are summed by
the in-process exchange (``comm.ReplicaGroup``), quantized with each
replica's error-feedback residual under ``compression``. Without
compression BatchNorm normalises over the global batch, as the JAX
package's partitioned step does; with it, over each replica's rows, with
the running statistics averaged. These steps run eager.

Data-parallel training (``kvstore="dist_sync"``) runs one process per
rank, as the JAX package's multi-process form does: every rank calls
``fit`` on its own rows, rank 0's initial parameters are broadcast, and
``rescale_grad`` is ``1/(batch_size*num_workers)``. After backward the
gradients are summed over the ranks (``comm.compressed_allreduce``, or
``comm.error_feedback_allreduce`` with a lossy ``compression``, whose
residual each rank keeps across steps), float auxiliary states are
averaged over the ranks and device metrics summed. Without compression
the step is the JAX package's partitioned one: BatchNorm normalises over
every rank's rows (``ops.nn.batch_statistics_over``), so the running
statistics come out equal and are not averaged. ``comm_kernels`` routes
the quantize stages through the fused kernels; ``overlap`` exchanges the
gradients bucket by bucket while backward runs (``comm.OverlapSchedule``).
``kvstore="dist_async"`` trains against the update-on-arrival parameter
host instead (mxnet_tpu/model.py:1258-1360).

The batches reach the device through a feed thread
(:class:`_DeviceFeed`, the counterpart of ``_AsyncDeviceFeed``): it draws
up to two batches ahead, copies them into pinned host memory and on to the
card on its own CUDA stream, and the step's stream waits on each batch's
event. ``MXTPU_FEED_PREFETCH=0`` feeds synchronously.

On a card each step replays a CUDA graph captured once per program key
(``utils/compile.py``: the graph's fingerprint, the bucket key, the input
shapes and dtypes, ``compute_dtype``, the pad policy, train or eval). The
step reads and writes only buffers that stay where they are (parameters,
moments, auxiliary states, one flat gradient buffer, static inputs the
feed's batch is copied into, and the optimizer's per-step values, copied
to the card before each step), so a replay is the eager step; the first
step of a key runs eager on a side stream and the second is captured.
``_eager_reason`` lists when a fit stays eager. ``precompile`` captures
ahead of ``fit``; ``predict`` and ``score`` replay one eval graph a key.

``fit(sharded_checkpoint_dir=, checkpoint_every_n_steps=)`` resumes from
and writes the sharded checkpoints of ``utils/checkpoint.py`` through
``resilience/ckpt_async.py``, with the JAX package's step-granular resume
(``mxnet_tpu/model.py:1180-1244``).

``fit(telemetry=, health=, profile=)`` and ``predict(telemetry=,
profile=)`` turn the observability layer on (``telemetry/``,
mxnet_tpu/model.py:1198-1201,1484-1498,1603-1672,2232-2390,2552-2640): a
step timeline whose ``device`` phase ends on a CUDA event the host waits
on after the step, MFU and goodput from one counted step, the JSONL
stream, the live-array ledger, the per-layer health statistics computed
inside the (captured) step, a bounded profile window whose steps run
eager with the profiler's ranges on, and a run record in the ledger.

``fit(guards=)`` guards each step as the JAX package does
(``resilience/guards.py``, mxnet_tpu/model.py:655-806,1529-1543,2205-2240):
the seed loss scaled by the device loss scale, the gradients unscaled, one
``finite`` flag on the device, and a non-finite step's parameters,
optimizer state, auxiliary states and metric put back from a snapshot
taken before it (``_StepGuard``; the update itself, ``fused_adam``
included, runs as it would unguarded). Transient step failures are
retried, a watchdog can bound step time, and SIGTERM (with guards or a
checkpoint directory) flushes a checkpoint and raises
``TrainingPreempted``. The chaos sites ``step.raise``, ``step.nan``,
``step.hang`` and ``ckpt.replica`` are in the step loop.

``fit(elastic=, controller=)`` resize the world of replicas mid-run and
close the loop from telemetry to actuation, as the JAX package does
(``resilience/elastic.py``, ``resilience/controller.py``,
mxnet_tpu/model.py:1368-1409,1502-1527,1790-1990,2026-2055,2108-2130,
2395-2403): one rank a ctx entry (aliases of one device included, so a
world of replicas runs on one card), a coordinator polled once a step
(chaos sites, heartbeats, then any pending change), and on a change the
replicas quiesce, the newest snapshot of the peer tier (else the newest
checkpoint on disk) is restored onto a new :class:`_ReplicaState` and
``_GradSync`` over the alive ranks, and the interrupted epoch is redone
from the snapshot's step. The controller ticks once a step before the
poll; a tier it stages is applied between two steps by rebuilding the
exchange (residuals start at zero), and a failure to apply it freezes
the controller, never the fit. Replica steps run eager, so a new world
has no program to warm.

``fit(shard_audit=)`` and ``precompile(shard_audit=)`` (or
``MXNET_TPU_SHARD_AUDIT``) audit each program of a fit with more than one
replica or rank before its first real step (``analysis/sharding.py``):
one step on zero inputs under the profiler, its collectives reconciled
against the exchange's plan, then every tensor, residual, guard counter
and generator it moved put back; a drift raises MXNetError naming MX802.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from . import comm as comm_mod
from . import initializer as init_mod
from . import io as io_mod
from . import kvstore as kvs_mod
from . import metric as metric_mod
from . import ndarray as nd
from . import optimizer as opt_mod
from . import random as random_mod
from . import symbol as sym_mod
from . import telemetry as telemetry_mod
from .base import MXNetError
from .callback import BatchEndParam
from .comm.allreduce import all_reduce_sum, broadcast_
from .context import Context, current_context, distinct_contexts
from .convert import to_tensor
from .executor import _build_graph_fn, _build_replica_graph_fn, has_native
from .kernels import fused_adam as kfa
from .ops.nn import batch_statistics_over
from .resilience import chaos as chaos_mod
from .resilience import ckpt_async as ckpt_plane
from .resilience import controller as fleetctl_mod
from .resilience import elastic as elastic_mod
from .resilience import guards as guards_mod
from .resilience import preempt as preempt_mod
from .resilience.retry import RetryingKVStore
from .telemetry import profiling as prof_mod
from .utils import checkpoint as ckpt_mod
from .utils import compile as compile_mod
from .utils.checkpoint import atomic_write, check_sidecar

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "opt_leaves"]

# the base class of FeedForward (mxnet_tpu/model.py:66)
BASE_ESTIMATOR = object

def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (names
    ``arg:<name>`` and ``aux:<name>``), each atomically with a sidecar."""
    atomic_write(f"{prefix}-symbol.json", lambda tmp: symbol.save(tmp))
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    atomic_write(f"{prefix}-{epoch:04d}.params",
                  lambda tmp: nd.save(tmp, save_dict))
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_checkpoint(prefix, epoch):
    """Load what either package's ``save_checkpoint`` wrote; returns
    ``(symbol, arg_params, aux_params)`` with CPU tensors. A params file
    that fails its sidecar raises."""
    params_path = f"{prefix}-{epoch:04d}.params"
    if check_sidecar(params_path) is False:
        raise MXNetError(
            f"checkpoint {params_path} fails its CRC sidecar "
            "(torn or corrupt write) — refusing to load")
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd.load(params_path).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _create_kvstore(kvstore, num_device, ctx):
    """The kvstore of a fit (mxnet_tpu/model.py:338-350): None for None,
    and for a local strategy over one device (a single device trains
    without a store); a store object (a ``resilience.RetryingKVStore``
    too) as it is; else the named store (a ``local`` or ``device`` store
    aggregates the pushes of several devices)."""
    if kvstore is None:
        return None
    if isinstance(kvstore, (kvs_mod.KVStore, RetryingKVStore)):
        return kvstore
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            return None
        return kvs_mod.create(kvstore, ctx=ctx)
    raise TypeError("kvstore must be KVStore, str or None")


def _init_iter(X, y, batch_size, shuffle=False, is_train=True):
    """An iterator over X: a DataIter as it is, arrays through NDArrayIter
    (batch size clamped to the dataset size)."""
    if isinstance(X, io_mod.DataIter):
        return X
    if isinstance(X, (np.ndarray, torch.Tensor)):
        if is_train and y is None:
            raise MXNetError("y is required when X is array-like")
        batch_size = min(batch_size, X.shape[0])
        return io_mod.NDArrayIter(X, y, batch_size=batch_size, shuffle=shuffle)
    raise MXNetError(f"cannot handle input type {type(X)}")


def _pad_rows(arrays: dict, target: int) -> dict:
    """Pad every array along axis 0 to ``target`` rows by repeating its last
    row (eval and predict tail batches; the extra rows are sliced off)."""
    out = {}
    for k, v in arrays.items():
        extra = target - v.shape[0]
        out[k] = torch.cat([v, v[-1:].expand(extra, *v.shape[1:])]) \
            if extra > 0 else v
    return out


class _GradSync:
    """The data-parallel part of a step, on one rank of ``num_workers``, or
    on every replica of a ``comm.ReplicaGroup`` (``group``; then each
    method takes and returns one value a replica, in a list): the gradient
    sum over the ranks (sum semantics; the optimizer's ``rescale_grad``
    makes it the mean), with each member's error-feedback residual for a
    lossy ``spec``; the mean of float auxiliary states; the sum of device
    metric accumulators. Registers its wire plan with ``comm.comm_stats()``
    once and records one step per gradient sync (mxnet_tpu/model.py:962-973).

    A member's gradients are views of one padded f32 buffer, laid out as
    the exchange flattens them (sorted names): :meth:`attach` points every
    parameter's ``.grad`` at its view before backward, and autograd
    accumulates each gradient into it in place. With error feedback the
    buffer is the residual itself, so that accumulation is the residual
    add (``r + g``, the bits of ``g + r``); else it starts at zero. The
    exchange reads the buffer as it is, and :meth:`grads` hands back views
    of its result: neither side copies.

    Under an overlap ``plan`` (``comm.plan_overlap``) the buffer is laid
    out bucket by bucket in schedule order, each bucket padded as
    ``plan.padded_sizes()`` says, and each bucket's exchange starts on a
    side stream as soon as backward has filled it
    (``comm.OverlapSchedule``); with error feedback each bucket's slice is
    its residual. The wire plan registered is then the per-bucket one."""

    LABEL = "train_step:dist_sync"

    def __init__(self, spec, kernels, params, num_workers, device,
                 plan=None, group=None):
        self.spec, self.kernels = spec, kernels
        self.num_workers = num_workers
        self.group = group
        self.replicas = group is not None
        devices = group.devices if self.replicas else [device]
        self.shapes = {k: tuple(v.shape) for k, v in params.items()}
        self.size = comm_mod.flat_size(params)
        self.plan = plan
        self.schedule = None
        self.flats = None  # the buffers backward accumulates into
        self._rows = None
        if plan is not None:
            self.schedule = comm_mod.OverlapSchedule(
                plan, device, group=group, kernels=kernels)
            comm_mod.registry().register_plan(self.LABEL, plan.wire_plan())
            return
        size = self.size
        padded = size if spec is None else \
            comm_mod.padded_flat_size(size, spec, num_workers)
        if spec is not None and spec.error_feedback:
            self._rows = [comm_mod.init_error_feedback(
                params, spec, num_workers, device=d) for d in devices]
        self._zeros = None if self._rows is not None else [
            torch.zeros(padded, dtype=torch.float32, device=d)
            for d in devices]
        comm_mod.registry().register_plan(
            self.LABEL, comm_mod.allreduce_plan(size, num_workers, spec))

    def _one(self, values):
        """A rank's one value, or every replica's list."""
        return values if self.replicas else values[0]

    @property
    def residual(self):
        """A rank's ``(1, Lp)`` residual row (None without feedback or
        under a plan)."""
        return None if self._rows is None else self._rows[0]

    @property
    def flat(self):
        """The buffer the last backward filled (the first member's)."""
        return None if self.flats is None else self.flats[0]

    def residuals(self):
        """Under a plan: ``{bucket_name: (members, Lp_b)}``, the
        per-bucket residual rows (None without feedback)."""
        return self.schedule.residuals() if self.schedule is not None \
            else None

    def comm_state(self):
        """``(state, layout_key)`` for a sharded checkpoint: the residual
        rows, ``(members, Lp)`` each, per bucket or under ``__fused__``,
        and the layout a resumed fit checks them against; ``(None, None)``
        without feedback (mxnet_tpu/model.py:1720-1728)."""
        if self.schedule is not None:
            state = self.residuals()
            return (None, None) if state is None else \
                (state, self.plan.layout_key())
        if self._rows is None:
            return None, None
        first = self._rows[0].device
        return ({"__fused__": torch.cat([r.to(first) for r in self._rows])},
                comm_mod.fused_layout_key(self.size, self.spec,
                                          self.num_workers))

    def load_comm_state(self, saved, layout, logger):
        """Adopt a checkpoint's residual rows when their layout still
        describes this exchange, else drop them, logging which, as the
        JAX package's resume does (mxnet_tpu/model.py:1466-1500)."""
        if saved is None:
            return
        state, key = self.comm_state()
        if state is None:
            return
        if self.schedule is not None:
            if layout == key and comm_mod.residuals_match_plan(
                    {k: v[:1] for k, v in saved.items()}, self.plan) and \
                    all(v.shape[0] == len(self.schedule.flats)
                        for v in saved.values()):
                self.schedule.load_residuals(saved)
                logger.info("resumed %d per-bucket EF residual ledger(s)",
                            len(saved))
            else:
                logger.info("EF residuals dropped on resume: bucket plan "
                            "changed (%s -> %s); starting a fresh ledger",
                            layout, key)
            return
        rows = saved.get("__fused__")
        if layout == key and rows is not None and \
                tuple(rows.shape) == tuple(state["__fused__"].shape):
            for m, r in enumerate(self._rows):
                r.copy_(torch.as_tensor(rows[m:m + 1]).to(r.device))
            logger.info("resumed fused EF residual")
        else:
            logger.info("EF residual dropped on resume: layout changed "
                        "(%s -> %s)", layout, key)

    def attach(self, params):
        """Point each parameter's ``.grad`` at its view of its member's
        buffer: the residual row, or the zeroed buffer. ``params`` is a
        rank's dict, or one dict a replica."""
        members = params if self.replicas else [params]
        if self.schedule is not None:
            self.schedule.attach(params)
            self.flats = list(self.schedule.flats)
            return
        if self._rows is not None:
            self.flats = [r[0] for r in self._rows]
        else:
            self.flats = [z.zero_() for z in self._zeros]
        for flat, p in zip(self.flats, members):
            views = comm_mod.flat_views(flat, self.shapes)
            for k, t in p.items():
                t.grad = views[k]

    def residual_copies(self):
        """Copies of the residual rows (:meth:`comm_state`'s), or None."""
        state, _ = self.comm_state()
        return None if state is None else \
            {k: v.clone() for k, v in state.items()}

    def restore_residuals(self, rows):
        """Put back rows :meth:`residual_copies` took."""
        if rows is None:
            return
        if self.schedule is not None:
            self.schedule.load_residuals(rows)
            return
        for m, r in enumerate(self._rows):
            r.copy_(rows["__fused__"][m:m + 1].to(r.device))

    def finish_backward(self):
        """After backward: under a plan, start the buckets backward left
        unready."""
        if self.schedule is not None:
            self.schedule.finish_backward()

    def close(self):
        if self.schedule is not None:
            self.schedule.close()

    def grads(self):
        """The exchange of the buffers backward filled: the summed
        gradients as views of the exchange's result, the new residual
        kept (a rank's dict, or one dict a replica)."""
        if self.schedule is not None:
            out = self.schedule.wait()
            self.flats = None
            comm_mod.registry().record_step(self.LABEL)
            return out
        flats = self._one(self.flats)
        if self._rows is not None:
            outs, rows = comm_mod.error_feedback_exchange(
                flats, self.spec, group=self.group,
                axis_size=self.num_workers, kernels=self.kernels)
            self._rows = rows if self.replicas else [rows]
        else:
            outs = comm_mod.compressed_exchange(
                flats, self.spec, group=self.group,
                axis_size=self.num_workers, kernels=self.kernels)
        self.flats = None
        comm_mod.registry().record_step(self.LABEL)
        outs = outs if self.replicas else [outs]
        return self._one([comm_mod.flat_views(o, self.shapes) for o in outs])

    def aux(self, aux):
        """Float auxiliary states averaged over the members (``pmean``), in
        one collective (a rank's dict, or one dict a replica)."""
        members = aux if self.replicas else [aux]
        names = [k for k in sorted(members[0])
                 if members[0][k].is_floating_point()]
        if not names:
            return aux
        flats = [torch.cat([a[k].reshape(-1).float() for k in names])
                 for a in members]
        summed = all_reduce_sum(self._one(flats), self.group)
        out = []
        for a, flat in zip(members, summed if self.replicas else [summed]):
            flat = flat / self.num_workers
            new, off = dict(a), 0
            for k in names:
                n = a[k].numel()
                new[k] = flat[off:off + n].reshape(a[k].shape).to(a[k].dtype)
                off += n
            out.append(new)
        return self._one(out)

    @staticmethod
    def metric(state):
        """A device metric's ``(sum, count)`` summed over the ranks."""
        return tuple(all_reduce_sum(t) for t in state)


def _cast_floats(values: dict, dtype) -> dict:
    """``values`` with each floating tensor cast to ``dtype``; None leaves
    them as they are."""
    if dtype is None:
        return values
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in values.items()}


def _cast_inputs(values: dict, dtype, names) -> dict:
    """``values`` with each tensor of ``names`` cast to ``dtype``, whatever
    its type: a uint8 image batch enters the training graph in ``dtype``
    (mxnet_tpu/model.py:673)."""
    if dtype is None:
        return values
    return {k: v.to(dtype) if k in names else v for k, v in values.items()}


class _DeviceFeed:
    """Feed/compute overlap for the train loop, the counterpart of the JAX
    package's ``_AsyncDeviceFeed`` (mxnet_tpu/model.py:192-282).

    A thread draws batches from the iterator, ``extract``s their host
    tensors, copies them into pinned host memory and issues ``non_blocking``
    copies to ``device`` on a stream of its own, then records an event.
    The consumer's stream waits on that event before the step reads the
    batch, and each device tensor is marked used on the consumer's stream
    (``record_stream``), so the caching allocator does not hand its memory
    out again while the step still reads it. ``depth`` bounds the batches
    in flight. An iterator's exception surfaces in the consuming thread;
    :meth:`close` stops and joins the thread. On a CPU device the thread
    only extracts. ``waits`` holds the seconds the consumer waited for each
    batch."""

    _SENTINEL = object()

    def __init__(self, data_iter, extract, device, depth=2):
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._err = None
        self._closed = False
        self._device = device
        self.waits = []
        cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if cuda else None

        def put(item):
            while not self._closed:
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(device)
                for batch in data_iter:
                    host = extract(batch)
                    if cuda:
                        pinned = {k: v.pin_memory() for k, v in host.items()}
                        with torch.cuda.stream(self._stream):
                            dev = {k: v.to(device, non_blocking=True)
                                   for k, v in pinned.items()}
                            event = torch.cuda.Event()
                            event.record(self._stream)
                    else:
                        dev, event = host, None
                    if not put((batch, dev, event)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                self._err = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mxtorch-feed")
        self._thread.start()

    def close(self):
        """Stop the thread and join it, so the caller may reset the
        iterator."""
        self._closed = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            logging.warning("feed thread still running after close() (the "
                            "data iterator is blocked in next())")

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._q.get()
            self.waits.append(time.perf_counter() - t0)
            if item is self._SENTINEL:
                self.waits.pop()
                if self._err is not None:
                    raise self._err
                return
            batch, dev, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for t in dev.values():
                    t.record_stream(stream)
            yield batch, dev


class _SyncFeed:
    """The feed without a thread (``MXTPU_FEED_PREFETCH=0``): each batch is
    extracted and copied when the loop asks for it; ``waits`` holds the
    seconds that took."""

    def __init__(self, data_iter, extract, device):
        self._iter, self._extract, self._device = data_iter, extract, device
        self.waits = []

    def close(self):
        pass

    def __iter__(self):
        it = iter(self._iter)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            dev = {k: v.to(self._device) for k, v in
                   self._extract(batch).items()}
            # a blocking host-to-card copy returns once it is done (torch
            # synchronizes the stream), so the wait is the feed's
            self.waits.append(time.perf_counter() - t0)  # mxlint: disable=MX306
            yield batch, dev


def opt_leaves(opt_state: dict) -> list:
    """The optimizer state's leaves in the JAX package's flattening order
    (names sorted, each state's tuple in order, None dropped): the
    ``state/opt`` list of a sharded checkpoint."""
    out = []
    for k in sorted(opt_state):
        v = opt_state[k]
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if t is not None)
    return out


def _assign(dst: torch.Tensor, value):
    """Copy ``value`` (a tensor or an array) into ``dst`` in place."""
    with torch.no_grad():
        dst.copy_(to_tensor(value, dst.device).to(dst.dtype).reshape(
            dst.shape))


class _StepScalars:
    """The per-step values of the in-place optimizer step
    (``Optimizer.step_vector``) on the device. ``dev`` stays where it is for
    the life of the trainer, so a captured step reads it at every replay;
    ``load`` fills it on the current stream before each step, on a card
    through a pinned copy of the values and a ``non_blocking`` copy (torch's
    caching host allocator keeps the pinned block until that copy ran)."""

    def __init__(self, device):
        self.device = device
        self.dev = None

    def load(self, values: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(values, np.float32))
        if self.dev is None or self.dev.numel() != host.numel():
            self.dev = torch.empty(host.numel(), dtype=torch.float32,
                                   device=self.device)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self.dev.copy_(host, non_blocking=True)


def _moved_opt_leaves(optimizer, opt_state) -> list:
    """The optimizer state a step writes on the device: Adam's moments
    (its step counters are host tensors, advanced apart), else every
    leaf."""
    if isinstance(optimizer, opt_mod.Adam):
        return [t for k in sorted(opt_state) for t in opt_state[k][:2]]
    return opt_leaves(opt_state)


class _StepGuard:
    """The non-finite guard of one trainer's steps
    (``resilience.guards``, mxnet_tpu/model.py:655-806), in tensors that
    stay where they are, so a captured step replays it.

    A step under the guard snapshots what it moves (parameters, the
    optimizer's device state, auxiliary states) into preallocated buffers
    before its forward (one ``torch._foreach_copy_``), scales the seed
    loss by the device loss scale and unscales the gradients before the
    exchange and the update, computes the ``finite`` flag after the
    exchange, runs the update as it would unguarded (``fused_adam``
    included, unchanged), then puts each moved tensor back from its
    snapshot where the step was not finite (``torch.where`` a leaf: the
    reference's select over the state after the update) and advances the
    guard counters. Nothing is read back to the host.

    Adam's per-leaf step counters advance on the host before each step
    (``Optimizer.step_vector``), where a skip cannot be known; under the
    guard they live on the device too (``counts``), the bias corrections
    are computed there from them and written over the host's in the
    step's vector, and a skipped step leaves them as they were, as the
    reference's select leaves its counters. The host's counters take the
    device's at each read (:meth:`read`). Without ``skip_nonfinite`` no
    snapshot is taken and nothing is put back; with the scale pinned at
    1.0 (``GuardConfig.pinned_unit_scale``) the loss and gradients are
    not scaled."""

    def __init__(self, cfg, state, scale=None):
        self.cfg = cfg
        self.device = state.device
        self.gstate = guards_mod.init_guard_state(cfg, scale,
                                                  device=self.device)
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.scaled = not cfg.pinned_unit_scale(scale)
        self._state = state
        self._moved = self._snap = None
        if cfg.skip_nonfinite:
            self._moved = (list(state.params.values())
                           + _moved_opt_leaves(state.optimizer,
                                               state.opt_state)
                           + list(state.aux.values()))
            with torch.no_grad():
                self._snap = [torch.empty_like(t) for t in self._moved]
        opt = state.optimizer
        self.counts = None
        if state.apply_update and isinstance(opt, opt_mod.Adam):
            self._betas = (np.float32(opt.beta1), np.float32(opt.beta2))
            self.counts = torch.zeros(len(state.names), dtype=torch.float32,
                                      device=self.device)
        self.load_counts()

    def key(self):
        return self.cfg.key() + (self.scaled,)

    def reset(self, scale=None):
        """Fresh counters and ``scale`` (the config's when None), written
        into the same tensors; the device step counts from the host's."""
        fresh = guards_mod.init_guard_state(self.cfg, scale)
        with torch.no_grad():
            for k, v in fresh.items():
                self.gstate[k].copy_(v)
            self.finite.fill_(True)
        self.load_counts()

    def load_counts(self):
        if self.counts is not None:
            st = self._state.opt_state
            host = [float(st[k][2]) for k in self._state.names]
            with torch.no_grad():
                self.counts.copy_(torch.tensor(host, dtype=torch.float32))

    def begin(self):
        """Before the forward: snapshot what the step moves."""
        if self._snap is not None:
            with torch.no_grad():
                torch._foreach_copy_(self._snap,
                                     [t.detach() for t in self._moved])

    def scale_loss(self, loss):
        return loss * self.gstate["scale"] if self.scaled else loss

    def unscale_(self, flats):
        """The gradient buffers times 1/scale, in place (before the
        exchange, as the reference unscales before its allreduce)."""
        if self.scaled:
            inv = 1.0 / self.gstate["scale"]
            with torch.no_grad():
                for f in flats:
                    f.mul_(inv)

    def prescale_(self, flats):
        """An error-feedback residual that backward accumulates onto,
        times the scale, so that unscaling the buffer leaves ``r + g/s``
        (exactly so for a power-of-two scale)."""
        if self.scaled:
            with torch.no_grad():
                for f in flats:
                    f.mul_(self.gstate["scale"])

    def write_corrections(self, scal):
        """Adam's bias corrections from the device step counts, written
        over the host's in the step vector ``scal``."""
        if self.counts is None:
            return
        t_new = self.counts + 1.0
        b1, b2 = (torch.full_like(t_new, float(b)) for b in self._betas)
        with torch.no_grad():
            scal[kfa.HEADER::kfa.PER_LEAF].copy_(1.0 - b1.pow(t_new))
            scal[kfa.HEADER + 1::kfa.PER_LEAF].copy_(1.0 - b2.pow(t_new))

    def finish(self, finite):
        """After the update: put back what a non-finite step moved, and
        advance the counters, the counts and the scale."""
        with torch.no_grad():
            if self._snap is not None:
                guards_mod.guard_select_(finite,
                                         [t.detach() for t in self._moved],
                                         self._snap)
            else:
                finite = torch.ones((), dtype=torch.bool, device=self.device)
            if self.counts is not None:
                torch.where(finite, self.counts + 1.0, self.counts,
                            out=self.counts)
            guards_mod.update_guard_state_(self.cfg, self.gstate, finite)
            self.finite.copy_(finite)

    def read(self) -> dict:
        """The counters on the host (one read), the host's Adam step counts
        set from the device's."""
        if self.counts is not None:
            st = self._state.opt_state
            for k, t in zip(self._state.names, self.counts.tolist()):
                st[k][2].fill_(t)
        return {"skipped_steps": int(self.gstate["skipped"]),
                "loss_scale": float(self.gstate["scale"])}


class _TrainState:
    """The device state of a trainer: parameters (autograd leaves),
    auxiliary states, optimizer state and the gradients, each in a buffer
    that stays where it is, and the training step in its phases (forward,
    backward, the gradient sync of data-parallel training, update), so
    that a caller can time them apart and a CUDA graph can capture them.

    A step reads and writes only those buffers: the forward copies the new
    auxiliary states (BatchNorm's running stats) into them, backward
    accumulates into views of one gradient buffer (``.grad``), and the
    update (``Optimizer.apply_inplace``) writes parameters and moments in
    place, reading lr and the per-leaf values from ``scalars.dev``, which
    :meth:`prepare` fills on the host's behalf before each step. A new
    value reaches the trainer only through :meth:`load` and
    :meth:`restore`, which copy into the buffers.

    With ``compute_dtype`` the forward runs on copies of the floating
    parameters and of every ``data_names`` input, whatever its type, cast
    to it (labels and auxiliary states stay as they are,
    mxnet_tpu/model.py:669-674); the parameters stay f32 masters, and
    autograd takes their gradients in f32 through the cast.

    ``symbol_for(bucket_key)`` gives the graph of a bucket (bucketing
    trainers); every bucket's graph reads the same parameters.
    ``programs`` holds the captured steps, one a program key."""

    def __init__(self, symbol, optimizer, params, aux, device, sync=None,
                 compute_dtype=None, data_names=(), symbol_for=None,
                 apply_update=True):
        self.device = device
        # False under dist_async: the parameter host applies the optimizer,
        # the step only takes the gradients (no optimizer state here)
        self.apply_update = apply_update
        self.symbol = symbol
        self.graph_fn = _build_graph_fn(symbol, is_train=True)
        self._symbol_for = symbol_for
        self._graph_fns = {}
        self.compute_dtype = compute_dtype
        self.data_names = frozenset(data_names)
        self.optimizer = optimizer
        self.grad_sync = sync
        # ranks exchanging uncompressed gradients compute the JAX package's
        # partitioned step: BatchNorm over every rank's rows
        self._rank_stats = sync is not None and not sync.replicas and \
            sync.spec is None
        self.params = {k: v.requires_grad_(True) for k, v in params.items()}
        self.names = list(self.params)
        self.aux = aux
        self.opt_state = optimizer.init_state_tree(self.params) \
            if apply_update else {}
        self.rng = random_mod.generator(device)
        self.scalars = _StepScalars(device)
        self.programs = {}
        # fit(health=): the statistics' static buffers and whether the
        # step computes them (a part of the program key)
        self.health = None
        self.health_on = False
        self._health_heads = ()
        self._loss = None
        self.grads = None
        self._grad_views = None
        # fit(guards=): the step's guard (a part of the program key), and
        # every guard made for this state by its key, kept so that a
        # captured step's tensors stay referenced
        self.guard = None
        self._guards = {}
        if sync is None:
            sizes = [v.numel() for v in self.params.values()]
            flat = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
            self._flat_grad = flat
            self._grad_views = {
                k: flat[o:o + n].view(v.shape) for (k, v), o, n in zip(
                    self.params.items(), np.cumsum([0] + sizes[:-1]), sizes)}

    def matches(self, optimizer, params: dict, aux: dict, device, sync,
                compute_dtype, apply_update=True) -> bool:
        """Can this state train ``params`` and ``aux`` with ``optimizer``
        (same names, shapes, device and settings)? Then a new ``fit``
        reuses it, captured steps included."""
        def sig(d):
            return [(k, tuple(v.shape)) for k, v in d.items()]

        return (sync is None and self.grad_sync is None
                and apply_update == self.apply_update
                and optimizer is self.optimizer and device == self.device
                and compute_dtype == self.compute_dtype
                and sig(params) == sig(self.params)
                and sig(aux) == sig(self.aux))

    def load(self, params: dict, aux: dict, opt_leaves_=None):
        """Copy parameter and auxiliary values into the buffers, and reset
        the optimizer state (or set it from a checkpoint's leaves), in
        place: a captured step reads these same tensors."""
        for k, v in params.items():
            _assign(self.params[k], v)
        for k, v in aux.items():
            _assign(self.aux[k], v)
        if not self.apply_update:
            return
        fresh = self.optimizer.init_state_tree(
            {k: v.detach() for k, v in self.params.items()})
        if opt_leaves_ is None:
            opt_leaves_ = opt_leaves(fresh)
        self.restore_opt(opt_leaves_)

    def restore_opt(self, leaves):
        """Set the optimizer state from its flat leaves, each copied into
        its tensor (Adam's host step counters included)."""
        mine = opt_leaves(self.opt_state)
        if len(mine) != len(leaves):
            raise MXNetError(f"optimizer state has {len(mine)} leaves, the "
                             f"checkpoint {len(leaves)}")
        for dst, v in zip(mine, leaves):
            _assign(dst, v)

    def snapshot(self) -> dict:
        """Device copies of everything a step moves, for :meth:`restore`."""
        with torch.no_grad():
            return {"params": {k: v.detach().clone()
                               for k, v in self.params.items()},
                    "aux": {k: v.clone() for k, v in self.aux.items()},
                    "opt": [t.clone() for t in opt_leaves(self.opt_state)],
                    "rng": random_mod.get_state()}

    def restore(self, snap: dict):
        self.load(snap["params"], snap["aux"], snap["opt"])
        random_mod.set_state(snap["rng"])

    def enable_health(self, groups, heads, on=True):
        """Compute the per-layer health statistics inside every step
        (``telemetry.health.DeviceStats``, made once a state and kept, so
        a captured step keeps writing the same buffers), or stop."""
        self.health_on = bool(on)
        if not on:
            return
        if self.health is None or self.health.groups != groups:
            self.health = telemetry_mod.health.DeviceStats(
                groups, self.params, self.device,
                flat_grad=getattr(self, "_flat_grad", None),
                grad_views=self._grad_views)
        self._health_heads = heads

    def health_loss(self, outs, batch, mask):
        """The step's unscaled training loss for the health stream: the
        loss heads' values, else the seed scalar backward starts from
        (mxnet_tpu/model.py:636-650,721-725)."""
        with torch.no_grad(), prof_mod.scope("health/loss"):
            loss = telemetry_mod.health.loss_value(
                self._health_heads, [o.detach() for o in outs], batch, mask)
            if loss is None and self._loss is not None:
                loss = self._loss.detach()
            return torch.zeros((), device=self.device) if loss is None \
                else loss

    def set_guard(self, cfg, scale=None):
        """Guard the steps with ``cfg`` (a ``GuardConfig``; None: no
        guard), starting from loss scale ``scale`` (the config's when
        None). A guard's tensors are made once a configuration and kept;
        a later fit resets their values in place."""
        if cfg is None:
            self.guard = None
            return None
        key = cfg.key() + (not cfg.pinned_unit_scale(scale),)
        guard = self._guards.get(key)
        if guard is None:
            guard = self._guards[key] = _StepGuard(cfg, self, scale)
        else:
            guard.reset(scale)
        self.guard = guard
        return guard

    def graph_fn_for(self, bucket_key):
        if bucket_key is None:
            return self.graph_fn
        if bucket_key not in self._graph_fns:
            self._graph_fns[bucket_key] = _build_graph_fn(
                self._symbol_for(bucket_key), is_train=True)
        return self._graph_fns[bucket_key]

    def prepare(self, lr):
        """The host part of a step: the optimizer's per-step values (lr,
        Adam's bias corrections) onto the device."""
        if not self.apply_update:
            return
        self.scalars.load(self.optimizer.step_vector(
            self.names, self.opt_state, lr))

    def forward(self, batch: dict, bucket_key=None, data_names=None,
                mask=None):
        """The training forward of ``bucket_key``'s graph (the symbol's
        when None); keeps the sum of the heads for backward and copies the
        moved auxiliary states into their buffers. ``data_names`` are the
        batch's data inputs (default: the trainer's); ``mask`` is the
        (batch,) row mask of a padded batch."""
        graph_fn = self.graph_fn_for(bucket_key)
        names = self.data_names if data_names is None else data_names
        with torch.enable_grad(), self._statistics():
            params = _cast_floats(self.params, self.compute_dtype)
            batch = _cast_inputs(batch, self.compute_dtype, names)
            outs, new_aux = graph_fn({**params, **batch}, self.aux, self.rng,
                                     mask)
            heads = [o for o in outs if o.requires_grad]
            # seed-ones cotangent: loss heads inject their own gradient
            with prof_mod.scope("loss/sum"):
                self._loss = sum(o.float().sum() for o in heads) \
                    if heads else None
        with torch.no_grad():
            for k, v in new_aux.items():
                if v is not self.aux[k]:
                    self.aux[k].copy_(v)
        return outs

    def _scale_loss(self, guard):
        """The seed loss times the guard's scale (what backward starts
        from); returns it detached, or a zero when no head needs it."""
        if self._loss is None:
            return torch.zeros((), device=self.device)
        self._loss = guard.scale_loss(self._loss)
        return self._loss.detach()

    def _statistics(self):
        """BatchNorm over every rank's rows for uncompressed multi-rank
        training (``ops.nn.batch_statistics_over``), else nothing."""
        return batch_statistics_over(None) if self._rank_stats \
            else contextlib.nullcontext()

    def _grad_flats(self) -> list:
        """The buffers backward accumulates the gradients into."""
        if self.grad_sync is not None:
            return list(self.grad_sync.flats)
        return [self._flat_grad]

    def backward(self):
        if self.grad_sync is not None:
            # into the sync's flat buffer, through each parameter's .grad
            self.grad_sync.attach(self.params)
            if self.guard is not None and self.grad_sync.residual is not None:
                # backward adds onto the residual: scale it alike
                self.guard.prescale_(self._grad_flats())
        else:
            self._flat_grad.zero_()
            for k, p in self.params.items():
                p.grad = self._grad_views[k]
            self.grads = self._grad_views
        if self._loss is not None:
            # a parameter no head depends on (fix_gamma's gamma) keeps 0
            with self._statistics():
                torch.autograd.backward(self._loss,
                                        inputs=list(self.params.values()))
        self._loss = None
        if self.grad_sync is not None:
            self.grad_sync.finish_backward()

    def sync(self):
        """Data-parallel training: the gradients summed over the ranks and
        the auxiliary states averaged (already equal, and left as they are,
        where BatchNorm took every rank's rows). A no-op on one device."""
        if self.grad_sync is not None:
            with torch.no_grad(), prof_mod.scope("comm/allreduce"):
                self.grads = self.grad_sync.grads()
                if self._rank_stats:
                    # every rank's statistics were the global batch's
                    return
                for k, v in self.grad_sync.aux(self.aux).items():
                    if v is not self.aux[k]:
                        self.aux[k].copy_(v)

    def update(self):
        """The optimizer step, in place, from the values :meth:`prepare`
        put on the device."""
        with torch.no_grad(), prof_mod.scope("optimizer/update"):
            self.optimizer.apply_inplace(self.params, self.grads,
                                         self.opt_state, self.scalars.dev)

    def step(self, batch: dict, bucket_key=None, data_names=None,
             probe=None):
        """One whole training step on the device: forward, backward, sync
        and update. A ``__num_valid__`` entry of ``batch`` (a padded batch)
        masks the rows after it out of the loss. Returns the detached
        outputs and ``probe(batch)`` (None without a probe)."""
        batch = dict(batch)
        mask = None
        num_valid = batch.pop("__num_valid__", None)
        if num_valid is not None:
            rows = next(iter(batch.values())).shape[0]
            mask = (torch.arange(rows, device=num_valid.device)
                    < num_valid).float()
        guard = self.guard
        if guard is not None:
            with prof_mod.scope("guards/snapshot"):
                guard.begin()
        outs = self.forward(batch, bucket_key, data_names, mask)
        health = self.health if self.health_on else None
        h_loss = None if health is None else \
            self.health_loss(outs, batch, mask)
        loss = None
        if guard is not None:
            loss = self._scale_loss(guard)
        self.backward()
        if guard is not None:
            guard.unscale_(self._grad_flats())
        self.sync()
        finite = None
        if guard is not None and guard.cfg.skip_nonfinite:
            with torch.no_grad(), prof_mod.scope("guards/finite"):
                if self.grad_sync is not None and \
                        not self.grad_sync.replicas:
                    # every rank's loss, as the reference's psum: the
                    # ranks skip together
                    loss = all_reduce_sum(loss)
                finite = guards_mod.finite_flag(loss, self.grads)
        if health is not None:
            with prof_mod.scope("health/stats"):
                health.before_update(self.params)
        if self.apply_update:
            if guard is not None:
                guard.write_corrections(self.scalars.dev)
            self.update()
        if guard is not None:
            with prof_mod.scope("guards/select"):
                guard.finish(finite)
        if health is not None:
            with prof_mod.scope("health/stats"):
                health.after_update(self.params, self.grads, h_loss)
        seen = None if probe is None else probe(batch)
        return [o.detach() for o in outs], seen


class _Program:
    """One program key's captured training step: static input buffers that
    the feed's batch is copied into, and the :class:`CapturedProgram` of
    the step over them (warm-up steps eager on a side stream, then one
    capture, then replays)."""

    def __init__(self, state, label, arrays, bucket_key, data_names, probe):
        self.static = {k: torch.empty_like(v) for k, v in arrays.items()}
        self.captured = compile_mod.CapturedProgram(
            lambda: state.step(self.static, bucket_key, data_names, probe),
            state.device, label, warmup=1, generators=[state.rng],
            inputs=lambda: [self.static, state.params, state.aux,
                            opt_leaves(state.opt_state), state.scalars.dev])

    def copy_in(self, arrays):
        for k, v in arrays.items():
            self.static[k].copy_(v, non_blocking=True)

    def run(self, arrays):
        self.copy_in(arrays)
        outs, seen = self.captured()
        return list(outs), seen


def _timed_feed(feed, tl):
    """Wrap the device feed so the time blocked waiting for the next batch
    is banked on the timeline as the following step's ``data_wait``
    phase."""
    it = iter(feed)
    while True:
        t0 = tl.clock()
        try:
            item = next(it)
        except StopIteration:
            return
        tl.note_data_wait(tl.clock() - t0)
        yield item


def _wait_step(device):
    """Wait for the step just launched on ``device``: the host waits on a
    CUDA event recorded after it (the JAX package's
    ``jax.block_until_ready`` on the step's outputs); the CPU's step has
    run when it returned."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def _ckpt_seconds():
    """The seconds checkpoint saves took so far (the hub's
    ``checkpoint_save_seconds`` histogram)."""
    h = telemetry_mod.hub().snapshot()["histograms"].get(
        "checkpoint_save_seconds")
    return h["sum"] if h else 0.0


def _split_rows(value, parts: int):
    """``value``'s rows cut into ``parts`` equal blocks: a device's
    ``P("dp")`` share. A batch the blocks cannot split raises what the JAX
    package's placement raises."""
    rows = int(value.shape[0])
    if rows % parts:
        raise ValueError(
            f"One of the batch's arrays was given a dp axis of {parts} "
            f"devices, which implies that the global size of its dimension "
            f"0 should be divisible by {parts}, but it is equal to {rows} "
            f"(full shape: {tuple(value.shape)})")
    return torch.split(value, rows // parts)


class _ReplicaState:
    """A trainer over the replicas of one process (a ctx list of distinct
    devices; the JAX package's single-process ``dp`` mesh): one
    :class:`_TrainState` a replica, each with its own parameters,
    auxiliary states, optimizer state and generator on its device, and a
    :class:`_GradSync` over a ``comm.ReplicaGroup``.

    A step cuts the batch's rows into one equal block a replica (its
    ``P("dp")`` rows), runs each replica's forward on its block, one
    backward through all of them, the exchange of the replicas' gradients
    (their sum, or ``compression``'s quantized exchange with each
    replica's error-feedback residual) and each replica's update, which
    leaves the replicas bitwise equal. ``global_stats`` (no compression)
    computes the JAX package's partitioned step, the single-device graph
    on the global batch: a training BatchNorm normalises over every
    replica's rows (:func:`~.executor._build_replica_graph_fn`) and the
    replicas' auxiliary states come out equal. With compression each
    replica normalises its own rows and the float auxiliary states are
    averaged over the replicas, as the JAX package's ``shard_map`` step
    does (mxnet_tpu/model.py:715-719). The outputs are the replicas'
    joined in row order on the first replica's device, so a metric reads
    the global batch. Steps run eager."""

    def __init__(self, symbol, optimizer, params, aux, devices, sync,
                 compute_dtype=None, data_names=(), symbol_for=None):
        self.devices = list(devices)
        self.device = self.devices[0]
        self.grad_sync = sync
        self.global_stats = sync.spec is None
        self.members = [
            _TrainState(symbol, optimizer,
                        {k: to_tensor(v, d).detach().clone()
                         for k, v in params.items()},
                        {k: to_tensor(v, d).detach().clone()
                         for k, v in aux.items()}, d,
                        sync=sync, compute_dtype=compute_dtype,
                        data_names=data_names, symbol_for=symbol_for)
            for d in self.devices]
        self.programs = {}  # never captured
        self._lockstep = {}

    # the first replica's state stands for all of them (they stay equal)
    params = property(lambda self: self.members[0].params)
    aux = property(lambda self: self.members[0].aux)
    opt_state = property(lambda self: self.members[0].opt_state)
    names = property(lambda self: self.members[0].names)
    optimizer = property(lambda self: self.members[0].optimizer)
    apply_update = property(lambda self: self.members[0].apply_update)

    @property
    def data_names(self):
        return self.members[0].data_names

    @data_names.setter
    def data_names(self, names):
        for m in self.members:
            m.data_names = names

    def load(self, params, aux, opt_leaves_=None):
        for m in self.members:
            m.load(params, aux, opt_leaves_)

    def restore_opt(self, leaves):
        for m in self.members:
            m.restore_opt(leaves)

    def set_sync(self, sync):
        """Exchange through ``sync`` from the next step on (a retier): its
        compression decides, as at construction, whether BatchNorm joins
        the replicas' rows."""
        self.grad_sync = sync
        self.global_stats = sync.spec is None
        for m in self.members:
            m.grad_sync = sync

    def set_guard(self, cfg, scale=None):
        """One guard a replica; they see one flag and stay equal."""
        return [m.set_guard(cfg, scale) for m in self.members][0]

    @property
    def guard(self):
        return self.members[0].guard

    def prepare(self, lr):
        for m in self.members:
            m.prepare(lr)

    @property
    def health(self):
        return self.members[0].health

    @property
    def health_on(self):
        return self.members[0].health_on

    def enable_health(self, groups, heads, on=True):
        """The statistics of the first replica (the replicas' gradients
        and updates are the exchanged, equal ones); the loss is the sum of
        every replica's."""
        self.members[0].enable_health(groups, heads, on)

    def _lockstep_fn(self, bucket_key):
        """The joined-statistics graph of ``bucket_key`` when it holds a
        BatchNorm, else None (the replicas' graphs are independent)."""
        if bucket_key not in self._lockstep:
            member = self.members[0]
            symbol = member._symbol_for(bucket_key) \
                if bucket_key is not None else member.symbol
            coupled = any(not n.is_variable and n.op.name == "BatchNorm"
                          for n in symbol._topo())
            self._lockstep[bucket_key] = _build_replica_graph_fn(
                symbol, is_train=True) if coupled else None
        return self._lockstep[bucket_key]

    def _forward_joined(self, fn, blocks, data_names, masks):
        names = self.members[0].data_names if data_names is None \
            else data_names
        dtype = self.members[0].compute_dtype
        with torch.enable_grad():
            args = [{**_cast_floats(m.params, dtype),
                     **_cast_inputs(b, dtype, names)}
                    for m, b in zip(self.members, blocks)]
            outs, new_aux = fn(args, [m.aux for m in self.members],
                               [m.rng for m in self.members], masks)
            for m, o in zip(self.members, outs):
                heads = [t for t in o if t.requires_grad]
                m._loss = sum(t.float().sum() for t in heads) \
                    if heads else None
        with torch.no_grad():
            for m, updated in zip(self.members, new_aux):
                for k, v in updated.items():
                    if v is not m.aux[k]:
                        m.aux[k].copy_(v)
        return outs

    def step(self, batch: dict, bucket_key=None, data_names=None,
             probe=None):
        """One training step over the replicas; returns the joined
        detached outputs and ``probe(batch)``."""
        batch = dict(batch)
        num_valid = batch.pop("__num_valid__", None)
        n = len(self.members)
        # the named ranges are the single device step's (the profiler's
        # attribution), with the batch's scatter to the replicas and the
        # outputs' gather as comm
        with prof_mod.scope("comm/scatter"):
            cut = {k: _split_rows(v, n) for k, v in batch.items()}
            blocks = [{k: parts[r].to(d) for k, parts in cut.items()}
                      for r, d in enumerate(self.devices)]
            masks = [None] * n
            if num_valid is not None:
                rows = next(iter(batch.values())).shape[0]
                mask = (torch.arange(rows, device=num_valid.device)
                        < num_valid).float()
                masks = [part.to(d) for part, d in
                         zip(_split_rows(mask, n), self.devices)]
        guards = [m.guard for m in self.members] \
            if self.members[0].guard is not None else None
        if guards is not None:
            with prof_mod.scope("guards/snapshot"):
                for g in guards:
                    g.begin()
        fn = self._lockstep_fn(bucket_key) if self.global_stats else None
        if fn is not None:
            outs = self._forward_joined(fn, blocks, data_names, masks)
        else:
            outs = [m.forward(b, bucket_key, data_names, mask)
                    for m, b, mask in zip(self.members, blocks, masks)]
        first = self.members[0]
        health = first.health if first.health_on else None
        h_loss = None
        if health is not None:
            with prof_mod.scope("health/loss"):
                h_loss = sum(m.health_loss(o, b, mask).to(self.device)
                             for m, o, b, mask in zip(self.members, outs,
                                                      blocks, masks))
        sync = self.grad_sync
        sync.attach([m.params for m in self.members])
        scaled = None
        if guards is not None:
            with prof_mod.scope("guards/scale"):
                scaled = [m._scale_loss(g)
                          for m, g in zip(self.members, guards)]
                if sync.residual is not None:
                    for g, f in zip(guards, sync.flats):
                        g.prescale_([f])
        with prof_mod.scope("loss/sum"):
            losses = [m._loss.to(self.device) for m in self.members
                      if m._loss is not None]
        if losses:
            torch.autograd.backward(
                sum(losses), inputs=[p for m in self.members
                                     for p in m.params.values()])
        for m in self.members:
            m._loss = None
        if guards is not None:
            with prof_mod.scope("guards/unscale"):
                for g, f in zip(guards, sync.flats):
                    g.unscale_([f])
        sync.finish_backward()
        with torch.no_grad(), prof_mod.scope("comm/allreduce"):
            grads = sync.grads()
            if not self.global_stats:
                for m, new in zip(self.members,
                                  sync.aux([m.aux for m in self.members])):
                    for k, v in new.items():
                        if v is not m.aux[k]:
                            m.aux[k].copy_(v)
        finite = None
        if guards is not None and guards[0].cfg.skip_nonfinite:
            with torch.no_grad(), prof_mod.scope("guards/finite"):
                # the replicas' summed loss, as the reference's psum
                finite = guards_mod.finite_flag(
                    sum(t.to(self.device) for t in scaled), grads[0])
        for i, (m, g) in enumerate(zip(self.members, grads)):
            m.grads = g
            if m is first and health is not None:
                with prof_mod.scope("health/stats"):
                    health.before_update(m.params)
            if m.apply_update:
                if guards is not None:
                    with prof_mod.scope("guards/corrections"):
                        guards[i].write_corrections(m.scalars.dev)
                m.update()
            if guards is not None:
                with prof_mod.scope("guards/select"):
                    guards[i].finish(None if finite is None
                                     else finite.to(m.device))
            if m is first and health is not None:
                with prof_mod.scope("health/stats"):
                    health.after_update(m.params, g, h_loss)
        with prof_mod.scope("comm/gather"):
            joined = [torch.cat([o[i].detach().to(self.device)
                                 for o in outs])
                      for i in range(len(outs[0]))]
        seen = None if probe is None else probe(batch)
        return joined, seen


class FeedForward(BASE_ESTIMATOR):
    """Model estimator over a loss-headed Symbol (reference: model.py:465).

    ``ctx`` defaults to ``[current_context()]``, which is ``gpu(0)`` outside
    a ``with mt.cpu():`` block. A list of several distinct devices (aliases
    of one device removed, ``context.distinct_contexts``) trains them as
    replicas of one process (:class:`_ReplicaState`), the JAX package's
    single-process ``dp`` mesh; ``predict`` and ``score`` run on the first.
    ``compute_dtype`` (a floating torch dtype: ``torch.bfloat16``) computes
    the forward and backward in that type with f32 master parameters, as
    the JAX package's mixed precision does; ``predict`` and ``score`` run
    in it too and return f32."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0,
                 compute_dtype=None, **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = list(ctx)
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        if compute_dtype is not None and not compute_dtype.is_floating_point:
            raise MXNetError(f"compute_dtype {compute_dtype} is not a "
                             "floating type")
        self.compute_dtype = compute_dtype
        self.kwargs = dict(kwargs)
        self._opt_cache = None
        self._train_state = None
        self._fps = {}
        self._seen = set()  # the program keys this trainer has seen
        # the eval programs: device parameters they read, programs by key
        self._eval_state = None
        self._eval_progs = {}
        # called as fn(batch, device_arrays) after each training step
        self._step_hook = None
        # called as fn(batch_arrays) inside each training step, on the
        # tensors the step reads (the static inputs of a captured one); its
        # value lands in step_probes as (batch, value)
        self._step_probe = None
        self.feed_waits = []
        self.step_probes = []
        self.async_rounds = []
        # observability handles of the last fit/predict (telemetry/)
        self.telemetry = None
        self.health_monitor = None
        self.profile_report = None
        self.mfu = None
        self._active_timeline = None
        # fit(guards=): skipped steps, retries and the loss scale
        self.guard_stats = None
        self._warmup_step = False
        # True during fit(elastic=): one rank a ctx entry, aliases included
        self._rank_per_ctx = False
        # fit/precompile(shard_audit=): the reports of the last fit, and
        # the seconds the audits' steps took
        self.shard_audit_reports = []
        self.shard_audit_seconds = 0.0
        # False until a fit's first step: a fit that raises before it puts
        # the telemetry world back
        self._fit_stepping = False

    # session state that pickle drops (mxnet_tpu/model.py:385-406): the
    # trainers, their captured programs and closures, the hooks and the
    # observability handles; the programs are rebuilt on first use
    _SESSION = {"_opt_cache": None, "_train_state": None, "_fps": dict,
                "_seen": set, "_eval_state": None, "_eval_progs": dict,
                "_step_hook": None, "_step_probe": None, "telemetry": None,
                "health_monitor": None, "_active_timeline": None}

    def __getstate__(self):
        state = self.__dict__.copy()
        for name in self._SESSION:
            state.pop(name, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        for name, default in self._SESSION.items():
            setattr(self, name, default() if callable(default) else default)

    def _symbol_for_bucket(self, bucket_key):
        """The graph of one bucket; one symbol here (bucketing trainers
        make one a key)."""
        del bucket_key
        return self.symbol

    @property
    def _replicas(self) -> list:
        """The ctx list's distinct devices, aliases removed, in list order
        (mxnet_tpu/model.py:449-460): one replica each. During an elastic
        fit every entry is a rank and a replica of its own, aliases
        included."""
        if self._rank_per_ctx:
            return list(self.ctx)
        return distinct_contexts(self.ctx)

    @property
    def _device(self) -> torch.device:
        """The first replica's device: the only one on one device, and
        where ``predict``, ``score`` and the metrics run on several."""
        return self._replicas[0].torch_device

    def _init_params(self, input_shapes, overwrite=False):
        """Infer shapes and run the initializer on the CPU for every
        parameter and auxiliary state not given."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        arg_names = self.symbol.list_arguments()
        param_names = [n for n in arg_names if n not in input_shapes]
        aux_names = self.symbol.list_auxiliary_states()
        shape_of = dict(zip(arg_names, arg_shapes))
        arg_params = dict(self.arg_params or {})
        aux_params = dict(self.aux_params or {})
        for names, shapes, store in (
                (param_names, [shape_of[n] for n in param_names], arg_params),
                (aux_names, aux_shapes, aux_params)):
            for name, shape in zip(names, shapes):
                if name in store and not overwrite:
                    continue
                arr = torch.zeros(shape, dtype=torch.float32)
                self.initializer(name, arr)
                store[name] = arr
        self.arg_params, self.aux_params = arg_params, aux_params
        return param_names, aux_names

    def _resolve_optimizer(self, param_names, batch_size, num_workers=1):
        """The optimizer object; a registry name is created once per
        (name, global batch size, kwargs) with ``rescale_grad =
        1/(batch_size*num_workers)`` (mxnet_tpu/model.py:501-518)."""
        opt = self.optimizer
        if not isinstance(opt, str):
            return opt
        sig = (opt, batch_size * num_workers,
               repr(sorted(self.kwargs.items(), key=lambda kv: kv[0])))
        if self._opt_cache is not None and self._opt_cache[0] == sig:
            return self._opt_cache[1]
        obj = opt_mod.create(opt,
                             rescale_grad=1.0 / (batch_size * num_workers),
                             arg_names=list(param_names), **self.kwargs)
        self._opt_cache = (sig, obj)
        return obj

    def _on_device(self, values: dict) -> dict:
        """Private device copies of parameter arrays: training updates them
        in place, so the caller's arrays are never written."""
        dev = self._device
        return {k: to_tensor(v, dev).detach().clone() for k, v in values.items()}

    def _fingerprint(self, bucket_key):
        if bucket_key not in self._fps:
            self._fps[bucket_key] = compile_mod.graph_fingerprint(
                self._symbol_for_bucket(bucket_key))
        return self._fps[bucket_key]

    def _label(self, kind, bucket_key):
        return (f"{kind}:{self._fingerprint(bucket_key)}"
                + (f":bucket={bucket_key}" if bucket_key is not None else ""))

    def _eager_reason(self, dist_sync=False, dist_async=False):
        """Why this trainer's steps run eager, or None when they are
        captured: the only cases, in the order they are checked (a CPU
        device, a ctx list of several devices, multi-worker dist_sync,
        overlapped or not, dist_async, a ``_Native`` node,
        ``MXTPU_CUDA_GRAPHS=0``). Remat steps are captured too: a recompute
        reads its forward's draws back (``ops.registry.DrawTape``)."""
        dev = self._device
        replicas = len(self._replicas)
        if dev.type == "cuda" and replicas > 1:
            return (f"a ctx list of {replicas} devices in one process (the "
                    "replicas' exchange runs between their steps)")
        if dev.type == "cuda" and dist_sync:
            return ("kvstore dist_sync over more than one worker (gloo "
                    "stages through host buffers)")
        if dev.type == "cuda" and dist_async:
            return ("kvstore dist_async (the round trip to the parameter "
                    "host is on the host)")
        return compile_mod.eager_reason(dev, has_native(self.symbol))

    def _state_for(self, optimizer, params, aux, sync, data_names,
                   apply_update=True):
        """The trainer's state: the last one when it can train these
        parameters (its captured steps with it), loaded in place, else a
        new one; over several replicas a new :class:`_ReplicaState`."""
        state = self._train_state
        dev = self._device
        if sync is not None and sync.replicas:
            self._train_state = None
            self._train_state = _ReplicaState(
                self.symbol, optimizer, params, aux,
                [c.torch_device for c in self._replicas], sync,
                compute_dtype=self.compute_dtype, data_names=data_names,
                symbol_for=self._symbol_for_bucket)
            return self._train_state
        if state is not None and state.matches(optimizer, params, aux, dev,
                                               sync, self.compute_dtype,
                                               apply_update):
            state.load(params, aux)
            state.data_names = frozenset(data_names)
            return state
        state = self._train_state = None
        state = _TrainState(
            self.symbol, optimizer, self._on_device(params),
            self._on_device(aux), dev, sync=sync,
            compute_dtype=self.compute_dtype, data_names=data_names,
            symbol_for=self._symbol_for_bucket, apply_update=apply_update)
        self._train_state = state
        return state

    def _program_key(self, arrays, bucket_key, pad_policy, train=True):
        key = compile_mod.program_key(
            self._fingerprint(bucket_key), bucket_key, arrays,
            self.compute_dtype, pad_policy, train)
        state = self._train_state
        if train and state is not None and state.health_on:
            # the health statistics are part of the step, as health's key
            # joins the JAX package's program cache key
            key = key + (telemetry_mod.HealthConfig().key(),)
        if train and state is not None and state.guard is not None:
            # so is the guard (mxnet_tpu/model.py:531)
            key = key + (state.guard.key(),)
        return key

    def _run_step(self, state, arrays, bucket_key, data_names, pad_policy,
                  lr, captured, precompile=False, eager=False):
        """One training step of the program ``arrays`` select: counted in
        the program registry (a first sight is a compile), the optimizer's
        values put on the device, then the step, replayed from its graph
        when ``captured`` and not ``eager`` (the FLOP count and the
        profile window run the step itself). Returns the outputs and the
        probe's value."""
        key = self._program_key(arrays, bucket_key, pad_policy)
        compile_mod.registry().see(self._label("train_step", bucket_key),
                                   key, self._seen, precompile=precompile)
        state.prepare(lr)
        self._warmup_step = False
        if not captured or eager:
            return state.step(arrays, bucket_key, data_names,
                              self._step_probe)
        prog = state.programs.get(key)
        if prog is None:
            prog = state.programs[key] = _Program(
                state, self._label("train_step", bucket_key), arrays,
                bucket_key, data_names, self._step_probe)
        cap = prog.captured
        # the program's warm-up step runs eager before its capture
        self._warmup_step = not cap.captured and cap.calls < cap.warmup
        return prog.run(arrays)

    @staticmethod
    def _shard_audit_plan(sync):
        """The closed-form plan ``sync`` registers with the comm registry
        (the per-bucket wire plan under overlap, else ``allreduce_plan``)
        and its compression: what the shard audit holds a step to."""
        if sync.plan is not None:
            return sync.plan.wire_plan(), sync.spec
        return comm_mod.allreduce_plan(sync.size, sync.num_workers,
                                       sync.spec), sync.spec

    @staticmethod
    def _step_snapshot(state):
        """Copies of everything one training step of ``state`` moves
        (each member's parameters, auxiliary states, optimizer state and
        guard, the exchange's residuals, the random state); returns the
        function that puts them back and forgets the step in the comm
        registry."""
        members = getattr(state, "members", [state])
        sync = state.grad_sync
        snaps = [m.snapshot() for m in members]
        guards = []
        with torch.no_grad():
            for m in members:
                g = m.guard
                if g is not None:
                    guards.append((g, {k: v.clone()
                                       for k, v in g.gstate.items()},
                                   None if g.counts is None
                                   else g.counts.clone(), g.finite.clone()))
        rows = sync.residual_copies()

        def restore():
            for m, snap in zip(members, snaps):
                m.restore(snap)
            with torch.no_grad():
                for g, gstate, counts, finite in guards:
                    for k, v in gstate.items():
                        g.gstate[k].copy_(v)
                    if counts is not None:
                        g.counts.copy_(counts)
                    g.finite.copy_(finite)
            sync.restore_residuals(rows)
            comm_mod.registry().record_step(sync.LABEL, -1)

        return restore

    def _shard_audit_program(self, state, arrays, bucket_key, data_names,
                             lr, *, raise_on_error=True, logger=None):
        """The sharding audit of one program (analysis/sharding.py,
        mxnet_tpu/model.py:2855-2893): one step of ``state`` on zero inputs
        of ``arrays``' shapes under the profiler, its collectives reconciled
        against the plan its exchange registers, then everything the step
        moved put back, so no real step runs before a drift raises.
        Returns the report; raises MXNetError on an error-grade finding
        when ``raise_on_error``. The seconds it took add up in
        ``self.shard_audit_seconds``."""
        from .analysis import sharding as shard_mod

        log = logger or logging
        t0 = time.perf_counter()
        sync = state.grad_sync
        plan, spec = self._shard_audit_plan(sync)
        members = getattr(state, "members", [state])
        # the members average their float auxiliary states unless
        # BatchNorm took every member's rows (replicas or ranks)
        averages_aux = not getattr(state, "global_stats",
                                   getattr(state, "_rank_stats", False))
        aux_elements = sum(v.numel() for v in members[0].aux.values()
                           if v.is_floating_point()) if averages_aux else 0
        zeros = {k: v.clone() if k == "__num_valid__" else torch.zeros_like(v)
                 for k, v in arrays.items()}
        dev = state.device
        label = self._label("train_step", bucket_key)
        restore = self._step_snapshot(state)
        try:
            state.prepare(lr)

            def step():
                state.step(zeros, bucket_key, data_names)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

            report = shard_mod.audit_step_program(
                step, plan=plan, compression=spec,
                axis_size=sync.num_workers, aux_elements=aux_elements)
        finally:
            restore()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the put-back copies, timed
        self.shard_audit_seconds += time.perf_counter() - t0
        for f in report.findings:
            log.warning("shard audit [%s]: %s", label, f.format())
        if raise_on_error and report.errors:
            first = report.errors[0]
            raise MXNetError(
                f"shard audit [{label}]: the step's collective set drifted "
                f"from the declared comm plan ({len(report.errors)} "
                f"error(s); first: {first.rule.id} {first.message}). Fix "
                f"the drift or disable the gate (shard_audit=False / unset "
                f"MXNET_TPU_SHARD_AUDIT)")
        return report

    def _resume(self, directory, logger):
        """Load the newest valid checkpoint under ``directory`` into the
        trainer's host parameters; returns ``(num_update, batches_done,
        opt_leaves, (comm_state, comm_layout), loss_scale)`` (zeros and
        Nones when there is none)."""
        last = ckpt_mod.latest_step(directory)
        if last is None:
            return 0, 0, None, (None, None), None
        params, aux, _, meta, leaves, comm_state = ckpt_mod.load_sharded(
            directory, last, with_comm=True)
        self.arg_params = {k: torch.from_numpy(v) for k, v in params.items()}
        self.aux_params = {k: torch.from_numpy(v) for k, v in aux.items()}
        self.begin_epoch = int(meta.get("epoch", last))
        batches_done = int(meta.get("batches_done", 0))
        if meta.get("rng_state") is not None:
            random_mod.set_state(meta["rng_state"])
        logger.info("resumed sharded checkpoint step %d (epoch %d, "
                    "batches_done %d)", last, self.begin_epoch, batches_done)
        return (int(meta.get("num_update", 0)), batches_done, leaves,
                (comm_state, meta.get("comm_layout")), meta.get("loss_scale"))

    def fit(self, X, y=None, eval_data=None, eval_metric="accuracy",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, batch_size=128,
            sharded_checkpoint_dir=None, guards=None, pad_policy=None,
            compression=None, overlap=None, comm_kernels=None,
            telemetry=None, elastic=None, controller=None, health=None,
            profile=None, shard_audit=None, checkpoint_every_n_steps=None):
        """Train (reference: model.py:669 fit). ``work_load_list`` is
        accepted and ignored, as in the JAX package.

        ``kvstore="dist_sync"`` trains data-parallel across the ranks of
        the world (``kvstore.create``): each rank passes its own rows. Then
        ``compression`` (None, a mode name, a dict or a
        ``comm.CompressionSpec``) picks what crosses the wire and
        ``comm_kernels`` (``comm.CommKernelConfig.resolve``) whether the
        quantize stages run as the fused kernels. On one rank compression
        is ignored, as in the JAX package. ``overlap`` (True, a bucket byte
        cap or a ``comm.OverlapConfig``; with compression) splits the sync
        into ~4 MB buckets in reverse-topological order, each exchanged on
        a side stream as soon as backward has filled it.

        ``kvstore="dist_async"`` trains against the parameter host
        (``kvstore_async.py``): the step takes the gradients, the host
        applies the optimizer on arrival, and one ``push_pull`` a step
        brings the weights back (``async_rounds`` holds each round trip's
        host-clock split). ``compression`` there quantizes the pushes,
        and ``overlap`` arms stale sync: the weights come back one round
        stale while the next step computes, drained at each epoch's end.

        ``pad_policy`` (``utils.compile.PadPolicy.resolve``) pads a short
        batch to the policy's rows and masks the padded rows out of the
        loss and the metric, so a tail batch needs no program of its own.

        ``sharded_checkpoint_dir`` resumes from the newest valid checkpoint
        there (epoch, ``num_update``, the batches already trained in that
        epoch, the random state and the optimizer state) and saves one at
        each epoch's end; ``checkpoint_every_n_steps`` (or
        ``MXNET_TPU_CKPT_STEPS``) also snapshots the state every N steps,
        written by a background thread (``resilience.ckpt_async``).

        On a card each step replays a CUDA graph captured once per program
        key, unless one of the cases of ``_eager_reason`` holds; the reason
        is counted in ``utils.compile.compile_stats()["eager"]``.

        ``guards`` (None: env ``MXNET_TPU_GUARDS``; True; a
        ``resilience.GuardConfig``) skips non-finite steps on the device,
        with an optional dynamic loss scale, retries a step whose dispatch
        raised ``TransientStepError`` (``max_step_retries``), and with
        ``watchdog_deadline`` raises ``StepTimeoutError`` when no step
        completes in time; ``self.guard_stats`` holds the skipped steps,
        retries and loss scale, read once an epoch. With guards or a
        ``sharded_checkpoint_dir``, SIGTERM flushes a checkpoint at the
        next step boundary and raises ``TrainingPreempted``. A loss scale
        other than a pinned 1.0 is refused with ``overlap``.

        ``telemetry`` (None: env ``MXNET_TPU_TELEMETRY``; True; a JSONL
        path; a ``telemetry.TelemetryConfig``) records a step timeline on
        ``self.telemetry``, MFU and goodput per epoch (FLOPs from one
        counted step), streams hub events to ``jsonl`` and tracks live
        NDArrays. ``health`` (None: env ``MXNET_TPU_HEALTH``; True; a
        ``telemetry.HealthConfig``) computes per-layer gradient, weight and
        update norms and nonfinite counts inside the (captured) step and
        feeds ``self.health_monitor``. ``profile`` (None: env
        ``MXNET_TPU_PROFILE``; True; window steps; a
        ``telemetry.ProfileConfig``) traces one window of steps, run eager
        with the profiler's ranges on, into ``self.profile_report``.

        ``elastic`` (None: env ``MXNET_TPU_ELASTIC``; True; a
        ``resilience.ElasticCoordinator``) resizes the world of replicas
        mid-run: it needs a ctx list (one rank an entry, aliases
        included), ``sharded_checkpoint_dir`` and a batch every world it
        may take divides; each step polls the coordinator, and a change
        restores the newest snapshot of the peer tier (else the disk's)
        onto the alive ranks and redoes the epoch from the snapshot's
        step (``co.history`` holds each resize and its downtime).
        ``controller`` (None: env ``MXNET_TPU_CONTROLLER``, ``dry`` to
        recommend only; True; a ``resilience.FleetControllerConfig`` or
        ``FleetController``) ticks the fleet controller once a step (or
        leaves it to its own thread after ``start()``): evictions and
        backfills go through ``elastic``'s coordinator, a tier it stages
        is applied between two steps, and a failure freezes the
        controller, not the fit. Its thread and the coordinator's
        heartbeat monitor stop when fit returns or raises."""
        # a fit that raises before its first step leaves the process's
        # telemetry world as it found it: the kvstore it made set the
        # world, and goes with the fit
        world = (telemetry_mod.current_rank(), telemetry_mod.world_size())
        self._fit_stepping = False
        try:
            return self._fit(
                X, y, eval_data, eval_metric, epoch_end_callback,
                batch_end_callback, kvstore, logger, batch_size,
                sharded_checkpoint_dir, guards, pad_policy, compression,
                overlap, comm_kernels, telemetry, elastic, controller, health,
                profile, shard_audit, checkpoint_every_n_steps)
        except BaseException:
            if not self._fit_stepping:
                telemetry_mod.set_world(*world)
            raise

    def _fit(self, X, y, eval_data, eval_metric, epoch_end_callback,
             batch_end_callback, kvstore, logger, batch_size,
             sharded_checkpoint_dir, guards, pad_policy, compression, overlap,
             comm_kernels, telemetry, elastic, controller, health, profile,
             shard_audit, checkpoint_every_n_steps):
        """The body of :meth:`fit`."""
        logger = logger or logging
        guard_cfg = guards_mod.GuardConfig.resolve(guards)
        pad_policy = compile_mod.PadPolicy.resolve(pad_policy)
        ckpt_every = ckpt_plane.resolve_every(checkpoint_every_n_steps)
        self._rank_per_ctx = False
        dev = self._device
        replicas = self._replicas
        kv = _create_kvstore(kvstore, len(self.ctx), replicas[0])
        num_workers = kv.num_workers if kv is not None else 1
        async_kv = kv is not None and kv.type == "dist_async"
        dist_sync = kv is not None and "dist" in kv.type and \
            not async_kv and num_workers > 1
        # elastic membership (mxnet_tpu/model.py:1368-1409): one rank a
        # ctx entry, which the coordinator resizes over
        elastic_co = elastic_mod.ElasticCoordinator.resolve(
            elastic, len(self.ctx))
        elastic_base_ctx = list(self.ctx)  # rank r -> its device, always
        if elastic_co is not None:
            if len(self.ctx) < 2:
                raise MXNetError(
                    "elastic= needs a multi-device world: give fit a ctx "
                    "list spanning the devices the world may resize over")
            if async_kv or num_workers > 1:
                raise MXNetError(
                    "elastic= resizes the world of replicas in one "
                    "process; multi-process worker membership is the "
                    "kvstore layer's job (membership epochs and leave/join "
                    "ops)")
            if sharded_checkpoint_dir is None:
                raise MXNetError(
                    "elastic= needs sharded_checkpoint_dir: a resize "
                    "restores optimizer state and EF residuals from the "
                    "CRC-manifest checkpoints")
            if elastic_co.full_world_size != len(self.ctx):
                raise MXNetError(
                    f"elastic coordinator world "
                    f"({elastic_co.full_world_size}) does not match the "
                    f"ctx list's length ({len(self.ctx)})")
            if elastic_co.min_world < 2:
                raise MXNetError(
                    "elastic= needs min_world >= 2: a resize must leave a "
                    "world of replicas to rebuild (single-device training "
                    "has no world to reshard onto)")
            self._rank_per_ctx = True
            replicas = self._replicas
        # several devices in one process: the replicas' exchange (the JAX
        # package's single-process dp mesh)
        multi = len(replicas) > 1
        if multi and (dist_sync or async_kv):
            raise MXNetError(
                f"a ctx list of {len(replicas)} devices trains them as "
                "replicas of one process; with kvstore='dist_sync' or "
                "'dist_async' across workers, run one process a device "
                "(ctx=one device each)")
        if sharded_checkpoint_dir is not None and num_workers > 1:
            raise MXNetError(
                "sharded_checkpoint_dir is not supported with multi-worker "
                f"kvstore='{kv.type}': workers hold diverged replicas and "
                "would race on one checkpoint directory; use "
                "epoch_end_callback=mx.callback.do_checkpoint(prefix) with "
                "a per-worker prefix instead")
        comm_spec = comm_mod.CompressionSpec.resolve(compression)
        overlap_cfg = comm_mod.OverlapConfig.resolve(overlap)
        comm_kernels = comm_mod.CommKernelConfig.resolve(comm_kernels)
        async_comm_spec = None
        if comm_spec is not None and async_kv:
            # gradients cross the parameter host's socket quantized and
            # bucketed (kvstore_async.py); no collective exchange
            kv.set_gradient_compression(comm_spec)  # mxlint: disable=MX311 - launch config, not mid-run actuation
            async_comm_spec, comm_spec = comm_spec, None
        elif comm_spec is not None and not dist_sync and not multi:
            logger.info("compression=%s ignored: single-device training "
                        "moves no gradient bytes over a wire",
                        comm_spec.mode)
            comm_spec = None
        # overlap= by path (mxnet_tpu/model.py:1309-1336): dist_async ->
        # stale sync, dist_sync with compression -> the per-bucket
        # schedule, anything else has no wire to hide
        stale_sync = False
        if overlap_cfg is not None and async_kv:
            stale_sync = True
            logger.info("overlap: stale-sync armed — bucket pushes lag "
                        "one step behind compute (weights one round "
                        "stale; ps-lite async heritage)")
            overlap_cfg = None
        elif overlap_cfg is not None and comm_spec is None:
            if dist_sync or multi:
                logger.info("overlap= ignored: the overlapped schedule "
                            "pipelines the quantized per-bucket sync — set "
                            "compression= to arm it")
            overlap_cfg = None
        num_update, skip_batches, resume_leaves = 0, 0, None
        resume_comm, resume_scale = (None, None), None
        if sharded_checkpoint_dir is not None:
            num_update, skip_batches, resume_leaves, resume_comm, \
                resume_scale = self._resume(sharded_checkpoint_dir, logger)
        train_data = _init_iter(X, y, batch_size, shuffle=True)
        batch_size = train_data.batch_size or batch_size
        data_shapes = dict(train_data.provide_data)
        label_shapes = dict(train_data.provide_label)
        data_names, label_names = list(data_shapes), list(label_shapes)
        param_names, aux_names = self._init_params({**data_shapes,
                                                    **label_shapes})
        optimizer = self._resolve_optimizer(param_names, batch_size,
                                            num_workers)
        self._optimizer_obj = optimizer
        axis = len(replicas) if multi else num_workers
        plan = None
        if overlap_cfg is not None:
            plan = comm_mod.plan_overlap(
                {k: tuple(self.arg_params[k].shape) for k in param_names},
                comm_spec, axis, max_bytes=overlap_cfg.bucket_bytes,
                symbol=self.symbol)
            logger.info(
                "overlap: %d bucket(s) scheduled reverse-topologically "
                "(cap %d bytes; per-bucket reduce-scatter/all-gather "
                "rides under backward)", plan.num_buckets,
                overlap_cfg.bucket_bytes)
        if async_kv:
            # update on the kvstore: the optimizer runs on the parameter
            # host at every push; rank 0's weights initialize the store and
            # every worker starts from the pulled copy
            kv.set_optimizer(optimizer)
            kv.init(param_names, [self.arg_params[k] for k in param_names])
            pulled = kv.pull_many(param_names)
            self.arg_params.update({k: torch.from_numpy(np.array(pulled[k]))
                                    for k in param_names})
        params = {k: self.arg_params[k] for k in param_names}
        aux = {k: self.aux_params[k] for k in aux_names}
        sync = None

        def replica_sync(spec, plan_, host_params):
            """The replicas' exchange over the current world."""
            return _GradSync(spec, comm_kernels, host_params, axis, dev,
                             plan=plan_, group=comm_mod.ReplicaGroup(
                                 [c.torch_device for c in replicas]))

        if dist_sync:
            params, aux = self._on_device(params), self._on_device(aux)
            # rank 0's initialization wins, like kvstore.init from rank 0
            # (mxnet_tpu/model.py:1273-1287)
            for k in sorted(params):
                broadcast_(params[k])
            for k in sorted(aux):
                broadcast_(aux[k])
            sync = _GradSync(comm_spec, comm_kernels, params, num_workers,
                             dev, plan=plan)
        elif multi:
            # every replica starts from the same host arrays
            sync = replica_sync(comm_spec, plan, params)
        state = self._state_for(optimizer, params, aux, sync, data_names,
                                apply_update=not async_kv)
        if resume_leaves is not None:
            state.restore_opt(resume_leaves)
        if sync is not None and sync.replicas:
            # the residual ledgers are saved only under one process's
            # replicas, as in the JAX package
            sync.load_comm_state(*resume_comm, logger)
        guard = state.set_guard(guard_cfg, resume_scale)
        if guard is not None and guard.scaled and plan is not None:
            raise MXNetError(
                "guards with a loss scale other than 1.0 and overlap=: the "
                "overlapped exchange starts buckets before backward ends, "
                "before their gradients could be unscaled; use "
                "GuardConfig(init_scale=1.0, dynamic_loss_scale=False) or "
                "the fused exchange")
        reason = self._eager_reason(dist_sync, async_kv)
        if reason is not None:
            compile_mod.note_eager(reason, logger)
        # the sharding audit (mxnet_tpu/model.py:1338-1346): each program
        # of a fit with more than one replica or rank is audited once, by
        # a step put back after, before its first real step
        from .analysis.sharding import shard_audit_enabled

        shard_audit_on = shard_audit_enabled(shard_audit)
        shard_audited = set()
        self.shard_audit_reports = []
        self.shard_audit_seconds = 0.0
        health_cfg = telemetry_mod.HealthConfig.resolve(health)
        profile_cfg = telemetry_mod.ProfileConfig.resolve(profile)
        tcfg = telemetry_mod.TelemetryConfig.resolve(telemetry)
        if num_workers > 1:
            # every event and metric of this process carries its rank
            telemetry_mod.set_world(kv.rank, num_workers)
        if health_cfg is not None and async_kv:
            logger.info("health= ignored with kvstore='dist_async': the "
                        "update happens on the parameter host")
            health_cfg = None
        health_groups = hmon = None
        state.enable_health(None, (), on=False)
        if health_cfg is not None:
            health_groups = telemetry_mod.health.layer_groups(param_names)
            state.enable_health(health_groups, telemetry_mod.health.
                                loss_heads(self.symbol, data_names
                                           + label_names))
            hmon = telemetry_mod.HealthMonitor(health_cfg).attach()
            self.health_monitor = hmon
            logger.info("health: per-layer stats in the step over %d "
                        "layer(s) (%r)", len(health_groups), health_cfg)
        elastic_prev_world = None
        if elastic_co is not None:
            # every event and metric carries the world of replicas, until
            # fit returns (mxnet_tpu/model.py:1400-1409)
            elastic_prev_world = (telemetry_mod.current_rank(),
                                  telemetry_mod.world_size())
            telemetry_mod.set_world(elastic_prev_world[0], len(replicas))
            telemetry_mod.gauge("elastic_world_size", float(len(replicas)))
        # the fleet controller (mxnet_tpu/model.py:1502-1527): membership
        # levers act through the coordinator; a tier it stages is applied
        # by this loop (apply_retier)
        fleet_ctl = fleetctl_mod.FleetController.resolve(controller)
        if fleet_ctl is not None:
            world_now = len(replicas) if multi else num_workers
            fleet_ctl.bind(
                coordinator=elastic_co,
                model_key=str(self._fingerprint(None)),
                world_size=world_now,
                comm_mode=comm_spec.mode if comm_spec is not None
                else "none",
                can_retier=multi and not async_kv,
                fp32_wire_bytes=comm_mod.fp32_allreduce_wire_bytes(
                    comm_mod.flat_size(params), world_now)
                if world_now > 1 else 0.0,
                health=hmon,
                ckpt_every=(ckpt_every if sharded_checkpoint_dir is not None
                            else None),
                logger=logger)
            logger.info("controller: %s (%r)", fleet_ctl.state,
                        fleet_ctl.cfg)
        self._memory_preflight(state, sync, logger)
        tl = mfu_acct = tel_sink = mem_prev = None
        if tcfg is not None:
            if tcfg.timeline:
                tl = telemetry_mod.StepTimeline()
                self.telemetry = tl
            if tcfg.mfu:
                mfu_acct = telemetry_mod.MFUAccountant(
                    num_devices=len(replicas) if multi else num_workers,
                    device=dev)
                self.mfu = mfu_acct
            if tcfg.jsonl:
                tel_sink = telemetry_mod.hub().add_sink(
                    telemetry_mod.JsonlWriter(tcfg.jsonl))
            if tcfg.memory:
                mem_prev = telemetry_mod.track_arrays(True)
                telemetry_mod.memory.reset_leak_tracker()
                telemetry_mod.memory.attach_sampler()
        self._active_timeline = tl
        ledger_t0 = telemetry_mod.hub().now()
        ledger_tic = time.time()
        ledger_comm0 = comm_mod.registry().stats()
        prof_session = None
        profile_badput = 0.0
        if profile_cfg is not None:
            layers = {n.name for n in self.symbol._topo()
                      if not n.is_variable}
            layers |= set(telemetry_mod.health.layer_groups(param_names))
            prof_session = telemetry_mod.profiling.ProfileSession(
                profile_cfg, layers=layers,
                num_devices=len(replicas) if multi else num_workers,
                mfu_acct=mfu_acct, logger=logger, owner="fit", device=dev)
            logger.info("profile: %r armed (window opens after warmup on "
                        "a capture-quiet step)", profile_cfg)
        eval_metric = metric_mod.create(eval_metric)
        device_metric = eval_metric.device_supported and \
            batch_end_callback is None
        cpu = torch.device("cpu")

        def extract(batch):
            arrays = {n: to_tensor(a, cpu) for n, a in zip(
                getattr(batch, "data_names", data_names), batch.data)}
            arrays.update({n: to_tensor(a, cpu) for n, a in zip(
                getattr(batch, "label_names", label_names), batch.label)})
            if pad_policy is not None:
                # on the feed thread, before the copy to the device: the
                # rows after num_valid are masked out of the loss
                rows = int(next(iter(arrays.values())).shape[0])
                arrays, num_valid = pad_policy.pad_arrays(
                    arrays, pad_policy.round_rows(rows, batch_size),
                    pad=getattr(batch, "pad", 0) or 0)
                arrays["__num_valid__"] = torch.tensor(num_valid,
                                                       dtype=torch.int32)
            return arrays

        writer = None
        if sharded_checkpoint_dir is not None and ckpt_every is not None:
            writer = ckpt_plane.AsyncCheckpointWriter(sharded_checkpoint_dir,
                                                      logger=logger)
            # the peer tier: one rank a replica (the JAX package's handle)
            self.ckpt_replicas = ckpt_plane.ReplicaStore(
                elastic_co.world_size if elastic_co is not None
                else len(replicas) if multi else 1)

        def comm_ckpt():
            """The replicas' residual ledgers and their layout key."""
            if sync is None or not sync.replicas:
                return None, {}
            rows, layout = sync.comm_state()
            return rows, ({} if layout is None else {"comm_layout": layout})

        def state_meta(epoch_, batches_done):
            meta = {"epoch": epoch_, "num_update": num_update}
            if ckpt_every is not None:
                meta.update(batches_done=int(batches_done),
                            rng_state=random_mod.get_state())
            if guard is not None:
                # one read: the loss scale, and Adam's host step counts
                # from the device's before the optimizer state is saved
                meta["loss_scale"] = guard.read()["loss_scale"]
            return meta

        # resilience (mxnet_tpu/model.py:1529-1543): nothing of it runs
        # unguarded and without a checkpoint directory
        watchdog = preempt = None
        if guard is not None:
            self.guard_stats = {
                "skipped_steps": 0, "step_retries": 0,
                "loss_scale": float(guard_cfg.init_scale
                                    if resume_scale is None
                                    else resume_scale)}
            if guard_cfg.watchdog_deadline:
                watchdog = guards_mod.StepWatchdog(
                    guard_cfg.watchdog_deadline)
        if sharded_checkpoint_dir is not None or guard is not None:
            preempt = preempt_mod.PreemptionHandler.install()

        def preempt_flush(epoch_, nbatch_):
            """SIGTERM landed: flush the live state (the in-progress
            epoch, or with a step cadence the step and the batches done)
            and stop with TrainingPreempted (mxnet_tpu/model.py:1730-1776)."""
            if stale_sync:
                # a round may be in flight: the flush saves pulled weights
                self._load_pulled(state, kv.flush_stale(param_names))
            if sharded_checkpoint_dir is not None:
                if writer is not None:
                    writer.flush()
                meta = state_meta(epoch_, nbatch_)
                rows, comm_meta = comm_ckpt()
                step_id = num_update if ckpt_every is not None else epoch_
                ckpt_plane.save_now(
                    sharded_checkpoint_dir, step_id, state.params,
                    aux=state.aux, symbol=self.symbol,
                    opt_state=opt_leaves(state.opt_state), comm_state=rows,
                    extra_meta={**meta, "preempted": True, **comm_meta},
                    keep=writer.keep_last_k if writer is not None else None)
                logger.info("preemption: flushed checkpoint step %d "
                            "(epoch %d, %d updates)", step_id, epoch_,
                            num_update)
            telemetry_mod.flight.auto_dump("preempt")
            self.arg_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in state.params.items()}
            self.aux_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in state.aux.items()}
            raise preempt_mod.TrainingPreempted(
                f"training preempted by SIGTERM during epoch {epoch_} "
                f"(checkpoint flushed: {sharded_checkpoint_dir is not None})",
                step=epoch_, epoch=epoch_)

        feed_depth = int(os.environ.get("MXTPU_FEED_PREFETCH", "2"))
        self.feed_waits, self.step_probes = [], []
        # dist_async: the host-clock seconds of each step's round trip
        self.async_rounds = []
        last_snapshot = -1
        epoch = self.begin_epoch
        resize_badput = 0.0  # seconds of the epoch lost to resizes

        def quiesce():
            """The replicas' queued work retires before their world or
            their exchange changes."""
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def apply_resize(ev):
            """Commit a polled membership change (mxnet_tpu/model.py:
            1790-1929): quiesce, restore the newest snapshot of the peer
            tier, else the newest checkpoint on disk, onto replicas of the
            alive ranks, re-plan the exchange, and let the loop redo the
            snapshot's epoch from its step. The downtime is a span of kind
            ``resize`` in the timeline and ``resize`` badput in goodput."""
            nonlocal state, sync, plan, guard, replicas, dev, axis, \
                num_update, skip_batches, epoch
            t0 = time.time()
            if batch_size % ev.world_size:
                raise MXNetError(
                    f"elastic resize to {ev.world_size} worker(s) "
                    f"impossible: global batch {batch_size} is not "
                    f"divisible by the new world; pick a batch divisible "
                    f"by every world size the job may shrink to")
            rspan = tl.begin_step(epoch, elastic_co.resizes, kind="resize") \
                if tl is not None else None
            try:
                quiesce()
                elastic_co.commit(ev, logger=logger)
                self.ctx = [elastic_base_ctx[r] for r in ev.ranks]
                if writer is not None:
                    # queued snapshots become the disk's newest state
                    writer.flush()
                restored = None
                store = self.ckpt_replicas if writer is not None else None
                if store is not None:
                    # a departed rank's copies are forgotten first, so a
                    # rejoin cannot bring stale state back
                    for r in range(store.world_size):
                        if r not in ev.ranks:
                            store.drop_rank(r)
                    restored = store.restore(alive=ev.ranks)
                if restored is not None:
                    host_params = restored.state.get("params", {})
                    host_aux = restored.state.get("aux", {})
                    meta = dict(restored.meta)
                    leaves = restored.state.get("opt")
                    comm_saved = restored.state.get("comm")
                    telemetry_mod.counter("ckpt_peer_restores_total")
                    # the peer tier restores host copies, and quiesce()
                    # synchronized the card: the seconds are the host's
                    telemetry_mod.emit("checkpoint", step=restored.step,
                                       seconds=time.time() - t0, tier="t1")  # mxlint: disable=MX306
                    logger.info("elastic: restored step %d from the "
                                "in-memory peer tier (no disk read)",
                                restored.step)
                else:
                    host_params, host_aux, _, meta, leaves, comm_saved = \
                        ckpt_mod.load_resharded(sharded_checkpoint_dir,
                                                None)
                # the old world's device state goes before the new one is
                # made: aliased replicas share one allocator
                sync.close()
                state = sync = guard = None
                self._train_state = None
                # the hooks of the old replicas' parameters make cycles
                gc.collect()
                replicas = self._replicas
                dev = self._device
                axis = len(replicas)
                if plan is not None:
                    plan = plan.replan(axis)
                host = {k: torch.from_numpy(np.asarray(host_params[k]))
                        for k in param_names}
                sync = replica_sync(comm_spec, plan, host)
                state = self._state_for(
                    optimizer, host,
                    {k: torch.from_numpy(np.asarray(host_aux[k]))
                     for k in aux_names}, sync, data_names)
                if leaves is not None:
                    state.restore_opt(leaves)
                # residuals survive only where their layout key matches,
                # which a changed world never does
                sync.load_comm_state(comm_saved, meta.get("comm_layout"),
                                     logger)
                guard = state.set_guard(guard_cfg, meta.get("loss_scale"))
                if guard is not None:
                    # the rolled-back device skip counter starts at 0
                    self.guard_stats["skipped_steps"] = 0
                if health_cfg is not None:
                    state.enable_health(
                        health_groups, telemetry_mod.health.loss_heads(
                            self.symbol, data_names + label_names))
                if mfu_acct is not None:
                    mfu_acct.set_num_devices(axis)
                num_update = int(meta.get("num_update", num_update))
                # the snapshot's epoch from the batches it had trained,
                # with the random state rewound to that step
                epoch = int(meta.get("epoch", epoch))
                skip_batches = int(meta.get("batches_done", 0))
                if meta.get("rng_state") is not None:
                    random_mod.set_state(meta["rng_state"])
            finally:
                if rspan is not None:
                    rspan.end()
            down = time.time() - t0
            elastic_co.record_downtime(down)
            logger.info(
                "elastic: redoing epoch %d on %d replica(s) after %.2fs "
                "resize (ranks %s, checkpoint step %s, %d update(s))",
                epoch, axis, down, list(ev.ranks), meta.get("step", "?"),
                num_update)

        def apply_retier(action):
            """A tier the controller staged (mxnet_tpu/model.py:1931-1990):
            the exchange rebuilt on the new compression, and optionally a
            bucket plan, between two steps; the residuals start at zero.
            Transactional: on an exception the old exchange stays, the
            failure counts against the controller's breaker, and training
            goes on."""
            nonlocal comm_spec, overlap_cfg, plan, sync
            old = (comm_spec, overlap_cfg, plan, sync)
            t0 = time.time()
            try:
                quiesce()
                mode = action["mode"]
                comm_spec = None if mode == "none" \
                    else comm_mod.CompressionSpec(mode)
                overlap_cfg = plan = None
                if comm_spec is not None and action.get("bucket_bytes"):
                    overlap_cfg = comm_mod.OverlapConfig(
                        action["bucket_bytes"])
                    plan = comm_mod.plan_overlap(
                        {k: tuple(v.shape) for k, v in state.params.items()},
                        comm_spec, axis, max_bytes=overlap_cfg.bucket_bytes,
                        symbol=self.symbol)
                if guard is not None and guard.scaled and plan is not None:
                    raise MXNetError(
                        "a loss scale other than 1.0 cannot take the "
                        "overlapped exchange")
                sync = replica_sync(comm_spec, plan, state.params)
                state.set_sync(sync)
                old[3].close()
                fleet_ctl.retier_applied(action, time.time() - t0)
                logger.info(
                    "controller: compression re-tiered to %s%s in %.2fs "
                    "(ratio %s)", mode,
                    f" + overlap cap {overlap_cfg.bucket_bytes}"
                    if overlap_cfg is not None else "",
                    time.time() - t0, action.get("ratio"))
            except Exception as e:  # noqa: BLE001 - the fit carries on
                if sync is not old[3]:
                    sync.close()
                comm_spec, overlap_cfg, plan, sync = old
                state.set_sync(sync)
                fleet_ctl.actuation_failed("retier", e, logger=logger)

        if elastic_co is not None and \
                ckpt_mod.latest_step(sharded_checkpoint_dir) is None:
            # a membership change in the first epoch needs a source to
            # restore from: the starting state is the floor checkpoint
            rows, comm_meta = comm_ckpt()
            ckpt_plane.save_now(
                sharded_checkpoint_dir,
                num_update if ckpt_every is not None else epoch,
                state.params, aux=state.aux, symbol=self.symbol,
                opt_state=opt_leaves(state.opt_state), comm_state=rows,
                extra_meta={**state_meta(epoch, skip_batches),
                            **comm_meta})
        try:
            epoch_tic = None
            while epoch < self.num_epoch:
                # the epoch's clock survives a redo: the aborted attempt
                # and the resize price into this epoch's wall and its
                # resize badput, never into throughput
                if epoch_tic is None:
                    epoch_tic = time.time()
                tic = epoch_tic
                attempt_tic = time.time()
                resize_ev = None
                compile_snap = compile_mod.registry().snapshot()
                span_base = len(tl.spans) if tl is not None else 0
                ckpt_base = _ckpt_seconds()
                if async_comm_spec is not None:
                    host_snap = kv.compression_stats()
                eval_metric.reset()
                mstate = eval_metric.device_init(dev) if device_metric \
                    else None
                nbatch = 0
                train_data.reset()
                feed = _DeviceFeed(train_data, extract, dev,
                                   depth=feed_depth) \
                    if feed_depth > 0 else _SyncFeed(train_data, extract, dev)
                feed_src = _timed_feed(feed, tl) if tl is not None else feed
                try:
                    for batch, arrays in feed_src:
                        if skip_batches > 0:
                            # a resumed epoch: past the batches it trained
                            skip_batches -= 1
                            nbatch += 1
                            continue
                        if fleet_ctl is not None:
                            # the policy tick, then a staged tier; the
                            # membership moves it makes surface through
                            # the elastic poll below
                            if not fleet_ctl.threaded:
                                fleet_ctl.tick()
                            retier_act = fleet_ctl.take_retier()
                            if retier_act is not None:
                                apply_retier(retier_act)
                        if elastic_co is not None:
                            # once a step: chaos sites, heartbeat expiry,
                            # then a pending change, which ends the attempt
                            elastic_co.chaos_poll()
                            elastic_co.check_heartbeats()
                            resize_ev = elastic_co.poll()
                            if resize_ev is not None:
                                break
                        span = tl.begin_step(epoch, nbatch) \
                            if tl is not None else None
                        if preempt is not None and \
                                preempt_mod.preemption_requested():
                            preempt_flush(epoch, nbatch)
                        if watchdog is not None:
                            watchdog.check()
                        if span is not None:
                            span.mark("dispatch")
                        b_lnames = getattr(batch, "label_names", label_names)
                        lr = optimizer._get_lr()
                        optimizer.num_update = num_update
                        window = prof_session is not None and \
                            (prof_session.pending or prof_session.open) and \
                            prof_session.before_step(
                                compile_mod.registry().snapshot()["compiles"])
                        if window and reason is None:
                            # a replay's kernels belong to no range: the
                            # window's steps run eager
                            compile_mod.registry().record_eager(
                                "profile window")

                        def run_step(eager=False):
                            return self._run_step(
                                state, arrays,
                                getattr(batch, "bucket_key", None),
                                getattr(batch, "data_names", None),
                                pad_policy, lr, reason is None, eager=eager)

                        def dispatch():
                            if mfu_acct is not None and \
                                    mfu_acct.wants_count:
                                return mfu_acct.count_step(
                                    lambda: run_step(eager=True))
                            return run_step(eager=window)

                        if shard_audit_on and sync is not None:
                            akey = (self._program_key(
                                arrays, getattr(batch, "bucket_key", None),
                                pad_policy), axis,
                                None if comm_spec is None else comm_spec.mode,
                                plan is not None)
                            if akey not in shard_audited:
                                shard_audited.add(akey)
                                self.shard_audit_reports.append(
                                    self._shard_audit_program(
                                        state, arrays,
                                        getattr(batch, "bucket_key", None),
                                        getattr(batch, "data_names", None),
                                        lr, logger=logger))
                        self._fit_stepping = True
                        if guard is None:
                            outs, seen = dispatch()
                        else:
                            arrays = self._chaos_step_sites(
                                arrays, getattr(batch, "data_names",
                                                data_names), watchdog)
                            retries = guard_cfg.max_step_retries
                            while True:
                                try:
                                    # raised before dispatch: the state is
                                    # as it was, so the step can run again
                                    chaos_mod.maybe_raise(
                                        "step.raise",
                                        chaos_mod.TransientStepError)
                                    outs, seen = dispatch()
                                    break
                                except chaos_mod.TransientStepError:
                                    if retries <= 0:
                                        telemetry_mod.flight.auto_dump(
                                            "guard_trip")
                                        raise
                                    retries -= 1
                                    self.guard_stats["step_retries"] += 1
                                    telemetry_mod.counter(
                                        "resilience_step_retries_total")
                                    if span is not None:
                                        span.event("step_retry")
                            if watchdog is not None and \
                                    not self._warmup_step:
                                # monitoring starts after the warm-up and
                                # the capture, as the reference's excludes
                                # the compile
                                watchdog.beat()
                        if span is not None:
                            span.mark("device")
                            if tcfg.sync:
                                _wait_step(dev)
                            span.mark("kvstore" if async_kv else "host")
                        if health_cfg is not None and \
                                nbatch % health_cfg.every == 0:
                            telemetry_mod.health.observe_device_stats(
                                health_groups, state.health.buffers, epoch,
                                nbatch)
                        if window:
                            profile_badput += prof_session.after_step(
                                outs, epoch=epoch)
                        step_finite = True
                        if guard is not None and (async_kv
                                                  or not device_metric):
                            # these paths read the host anyway; a captured
                            # step with a device metric never does
                            step_finite = bool(
                                guard.gstate["last_finite"] > 0)
                        if async_kv:
                            self.async_rounds.append(self._async_round(
                                kv, state, param_names, stale_sync,
                                finite=step_finite))
                            if span is not None:
                                span.mark("host")
                        if seen is not None:
                            self.step_probes.append((batch, seen.clone()))
                        if self._step_hook is not None:
                            self._step_hook(batch, arrays)
                        num_update += 1
                        labels = [arrays[n] for n in b_lnames]
                        preds = [o.float() for o in outs[:len(labels)]]
                        if pad_policy is not None:
                            nv = int(batch.data[0].shape[0]) - int(
                                getattr(batch, "pad", 0) or 0)
                            labels = [t[:nv] for t in labels]
                            preds = [t[:nv] for t in preds]
                        with prof_mod.scope("metric/update"):
                            if device_metric:
                                new = eval_metric.device_update(
                                    mstate, labels, preds)
                                if guard is not None and \
                                        guard.cfg.skip_nonfinite:
                                    # a skipped step leaves the metric too
                                    new = tuple(guards_mod.guard_select(
                                        guard.finite, list(new),
                                        list(mstate)))
                                mstate = new
                            elif step_finite:
                                eval_metric.update(labels, preds)
                        nbatch += 1
                        if writer is not None and \
                                num_update % ckpt_every == 0 and \
                                num_update != last_snapshot:
                            last_snapshot = num_update
                            rows, comm_meta = comm_ckpt()
                            snap = ckpt_plane.capture_snapshot(
                                num_update, state.params, aux=state.aux,
                                opt_state=opt_leaves(state.opt_state),
                                comm_state=rows,
                                meta={**state_meta(epoch, nbatch),
                                      **comm_meta},
                                symbol=self.symbol)
                            writer.submit(snap)
                            writer.note_step(num_update)
                            # to every alive rank's peer; a copy can be
                            # lost mid-replication
                            store = self.ckpt_replicas
                            for r in (elastic_co.alive
                                      if elastic_co is not None
                                      else range(store.world_size)):
                                if not chaos_mod.fires("ckpt.replica"):
                                    store.replicate(r, snap)
                        if writer is not None and fleet_ctl is not None:
                            ckpt_act = fleet_ctl.take_ckpt_cadence()
                            if ckpt_act is not None:
                                # a staged cadence: a step-loop counter,
                                # nothing is rebuilt
                                ckpt_every = max(1, int(ckpt_act["every"]))
                                fleet_ctl.ckpt_cadence_applied(ckpt_act)
                                logger.info("controller: checkpoint "
                                            "cadence -> every %d step(s)",
                                            ckpt_every)
                        if batch_end_callback is not None:
                            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                                  eval_metric=eval_metric)
                            for cb in _as_list(batch_end_callback):
                                cb(param)
                        if span is not None:
                            span.end()
                        else:
                            # the flight recorder's step mark, timeline or
                            # not: a crash dump shows the last steps
                            telemetry_mod.flight.note_step(epoch, nbatch - 1)
                finally:
                    feed.close()
                    self.feed_waits.extend(feed.waits)
                if resize_ev is not None:
                    # the attempt's steps are redone on the new world: they
                    # and the resize are this epoch's resize badput
                    apply_resize(resize_ev)
                    resize_badput += time.time() - attempt_tic
                    continue
                if prof_session is not None and prof_session.open:
                    # the epoch ended inside the window: close with what
                    # was captured
                    profile_badput += prof_session.close(epoch=epoch)
                if stale_sync:
                    # the last step's push must land before callbacks and
                    # checkpoints read the weights
                    self._load_pulled(state, kv.flush_stale(param_names))
                if async_comm_spec is not None:
                    hs = kv.compression_stats()
                    sent = hs["bytes_encoded"] - host_snap["bytes_encoded"]
                    raw = hs["bytes_raw"] - host_snap["bytes_raw"]
                    if sent:
                        logger.info(
                            "Epoch[%d] Comm: %.2f MB pushed to the parameter "
                            "host (%s; fp32 would be %.2f MB, %.1fx)", epoch,
                            sent / 1e6, async_comm_spec.mode, raw / 1e6,
                            raw / sent)
                if device_metric:
                    if dist_sync:
                        mstate = sync.metric(mstate)
                    eval_metric.absorb_device_state(mstate)
                name, value = eval_metric.get()
                logger.info("Epoch[%d] Train-%s=%f", epoch, name, value)
                if dev.type == "cuda":
                    # the epoch's clock stops when its last step has run
                    torch.cuda.synchronize(dev)
                logger.info("Epoch[%d] Time cost=%.3f", epoch,
                            time.time() - tic)
                cdiff = compile_mod.registry().snapshot()
                if mfu_acct is not None and nbatch:
                    spans_e = tl.spans[span_base:] if tl is not None else []
                    mfu_acct.epoch_report(
                        epoch, nbatch, time.time() - tic,
                        compile_seconds=cdiff["compile_seconds"]
                        - compile_snap["compile_seconds"],
                        data_wait_seconds=sum(
                            d for sp in spans_e for n, _, d in sp.phases()
                            if n == "data_wait"),
                        checkpoint_seconds=_ckpt_seconds() - ckpt_base,
                        resize_seconds=resize_badput,
                        profile_seconds=profile_badput, logger=logger)
                profile_badput = 0.0
                if guard is not None:
                    # the once-an-epoch read of the device counters
                    read = guard.read()
                    skipped_delta = read["skipped_steps"] - \
                        self.guard_stats["skipped_steps"]
                    self.guard_stats.update(
                        skipped_steps=read["skipped_steps"],
                        loss_scale=read["loss_scale"])
                    if skipped_delta > 0:
                        telemetry_mod.counter(
                            "resilience_skipped_steps_total", skipped_delta)
                    telemetry_mod.gauge("loss_scale", read["loss_scale"])
                    if read["skipped_steps"] or \
                            self.guard_stats["step_retries"]:
                        logger.info(
                            "Epoch[%d] Guard: skipped_steps=%d "
                            "step_retries=%d loss_scale=%g", epoch,
                            read["skipped_steps"],
                            self.guard_stats["step_retries"],
                            read["loss_scale"])
                if sharded_checkpoint_dir is not None:
                    if writer is not None:
                        # a queued snapshot may share this step id
                        writer.flush()
                    # the next epoch from its top; one step-id namespace
                    # (num_update) when snapshots are armed, else epochs
                    rows, comm_meta = comm_ckpt()
                    ckpt_plane.save_now(
                        sharded_checkpoint_dir,
                        num_update if ckpt_every is not None else epoch + 1,
                        state.params, aux=state.aux, symbol=self.symbol,
                        opt_state=opt_leaves(state.opt_state),
                        comm_state=rows,
                        extra_meta={**state_meta(epoch + 1, 0),
                                    **comm_meta},
                        keep=writer.keep_last_k if writer is not None
                        else None)
                # write back, so callbacks and checkpoints see this epoch's
                # state
                self.arg_params = {k: v.detach().to("cpu", copy=True)
                                   for k, v in state.params.items()}
                self.aux_params = {k: v.detach().to("cpu", copy=True)
                                   for k, v in state.aux.items()}
                if eval_data is not None:
                    eval_metric.reset()
                    eval_iter = _init_iter(eval_data[0], eval_data[1],
                                           batch_size, is_train=False) \
                        if isinstance(eval_data, tuple) else eval_data
                    self._eval(eval_iter, eval_metric, data_names,
                               label_names)
                    name, value = eval_metric.get()
                    logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                                value)
                if mem_prev is not None:
                    # close the epoch's watermark window and run the leak
                    # detector
                    telemetry_mod.memory.epoch_mark(epoch, logger=logger)
                if epoch_end_callback is not None:
                    if preempt is not None and \
                            preempt_mod.preemption_requested():
                        # no callbacks on a dead clock
                        preempt_flush(epoch, nbatch)
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, self.arg_params,
                           self.aux_params)
                epoch_tic = None
                resize_badput = 0.0
                epoch += 1
        finally:
            if fleet_ctl is not None:
                # no controller thread outlives the fit
                fleet_ctl.stop()
                fleet_ctl.unbind()
            if elastic_co is not None:
                elastic_co.stop_heartbeat_monitor()
                telemetry_mod.set_world(*elastic_prev_world)
            self._rank_per_ctx = False
            if watchdog is not None:
                watchdog.stop()
            if preempt is not None:
                preempt_mod.PreemptionHandler.uninstall()
            if writer is not None:
                writer.close()
            if sync is not None:
                sync.close()
            if hmon is not None:
                hmon.detach()
            if prof_session is not None:
                # an exception mid-window must not leave the profiler
                # running
                prof_session.close()
                self.profile_report = prof_session.report
            telemetry_mod.clear_current_span()
            self._active_timeline = None
            if tel_sink is not None:
                telemetry_mod.hub().remove_sink(tel_sink)
                tel_sink.close()
            if mem_prev is not None:
                telemetry_mod.memory.detach_sampler()
                telemetry_mod.track_arrays(mem_prev)
            try:
                spec = comm_spec if comm_spec is not None \
                    else async_comm_spec
                telemetry_mod.ledger.record_run(
                    "fit", fingerprint=str(self._fingerprint(None)),
                    world_size=len(replicas) if multi else num_workers,
                    knobs={
                        "compression": spec.mode if spec is not None
                        else "none",
                        "overlap_bytes": overlap_cfg.bucket_bytes
                        if overlap_cfg is not None else None,
                        "comm_kernels": bool(comm_kernels),
                        "fused_adam": bool(getattr(
                            optimizer, "_fused_active", lambda: False)()),
                        "pad_policy": pad_policy.mode
                        if pad_policy is not None else None,
                        "health": health_cfg is not None,
                        "profile": profile_cfg is not None,
                        "guards": guard_cfg is not None,
                        "ckpt_every": ckpt_every,
                    },
                    completed=sys.exc_info()[0] is None,
                    since_ts=ledger_t0, comm_start=ledger_comm0,
                    wall_seconds=time.time() - ledger_tic, logger=logger)
            except Exception as e:  # noqa: BLE001 - never mask the run
                logger.warning("telemetry ledger: run record failed: %s", e)
        return self

    def _memory_preflight(self, state, sync, logger):
        """The OOM preflight before the first step
        (mxnet_tpu/model.py:1603-1620): the resident state (parameters,
        optimizer state, auxiliary states, the exchange's residuals) and
        the largest captured training program's plan of this trainer,
        against ``telemetry.memory.hbm_budget()`` (the card's limit by
        default; none on the CPU). A program's plan exists from its
        capture on, so the first fit of a trainer checks the state alone:
        the check never refuses a fit that fits."""
        budget = telemetry_mod.memory.hbm_budget()
        if budget is None:
            return None
        labels = [label for label in compile_mod.memory_plans()
                  if label.startswith(self._label("train_step", None))]
        plan_label, plan = telemetry_mod.memory.largest_plan(labels=labels)
        resid = None
        if sync is not None:
            resid = sync.residuals() if sync.schedule is not None \
                else sync.residual
        entries = telemetry_mod.memory.preflight_entries(
            dict(state.params), opt_leaves(state.opt_state), dict(state.aux),
            resid=resid, plan_label=plan_label, plan=plan)
        return telemetry_mod.memory.preflight(entries, budget, what="fit",
                                              logger=logger)

    @staticmethod
    def _chaos_step_sites(arrays, data_names, watchdog):
        """The guarded loop's fault sites (no work unless chaos is armed,
        mxnet_tpu/model.py:2896-2921): ``step.hang`` stalls until the
        watchdog trips; ``step.nan`` poisons the first floating data
        input, on the device, before it is copied into a captured step's
        input buffer."""
        cz = chaos_mod.active()
        if cz is None:
            return arrays
        if cz.fires("step.hang"):
            limit = time.monotonic() + (
                3.0 * watchdog.deadline if watchdog is not None else 1.0)
            while time.monotonic() < limit:
                if watchdog is not None:
                    watchdog.check()  # raises StepTimeoutError when tripped
                time.sleep(0.01)
        if cz.fires("step.nan"):
            for name in data_names:
                v = arrays.get(name)
                if v is not None and v.is_floating_point():
                    arrays = dict(arrays)
                    arrays[name] = v * float("nan")
                    break
        return arrays

    @staticmethod
    def _load_pulled(state, pulled: dict):
        """Copy weights pulled from the parameter host into the trainer's
        parameters, in place."""
        for k, v in pulled.items():
            _assign(state.params[k], v)

    def _async_round(self, kv, state, names, stale, finite=True):
        """One step's round trip with the dist_async parameter host: the
        gradients to the host (one copy of the flat buffer), ``push_pull``
        (or ``push_pull_stale``: the weights one round stale), the
        returned weights into the parameters. A step the guard found not
        ``finite`` pushes nothing: the in-flight round drains, or the
        current weights are pulled (mxnet_tpu/model.py:2305-2330).
        Returns the host-clock seconds of each part."""
        t0 = time.perf_counter()
        if not finite:
            pulled = kv.flush_stale(names) if stale else kv.pull_many(names)
            t1 = time.perf_counter()
            self._load_pulled(state, pulled)
            if state.device.type == "cuda":
                torch.cuda.synchronize(state.device)
            return {"to_host_s": 0.0, "push_pull_s": t1 - t0,
                    "to_card_s": time.perf_counter() - t1}
        flat = state._flat_grad.detach().to("cpu").numpy()
        grads, off = {}, 0
        for k in state.names:
            n = state.params[k].numel()
            grads[k] = flat[off:off + n].reshape(state.params[k].shape)
            off += n
        t1 = time.perf_counter()
        grads = {k: grads[k] for k in names}
        pulled = kv.push_pull_stale(grads) if stale else kv.push_pull(grads)
        t2 = time.perf_counter()
        self._load_pulled(state, pulled)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        t3 = time.perf_counter()
        return {"to_host_s": t1 - t0, "push_pull_s": t2 - t1,
                "to_card_s": t3 - t2}

    def precompile(self, data_shapes=None, label_shapes=None, *, data=None,
                   eval_metric="accuracy", kvstore="local", guards=None,
                   pad_policy=None, compression=None, overlap=None,
                   comm_kernels=None, batch_end_callback=None, health=None,
                   parallel=True, shard_audit=None):
        """Capture every training program ``fit`` would need before
        training, without moving any parameter, moment, running statistic,
        random state or step count: each program's warm-up step runs on
        zero inputs and its graph is captured, then the state is put back.
        A ``fit`` with the same shapes then captures nothing.

        Shapes: ``data_shapes``/``label_shapes`` (input name -> full batch
        shape, or ``(shape, dtype)``), or ``data=`` a DataIter (its
        ``provide_data``/``provide_label``; a ``BucketSentenceIter`` gives
        one program per non-empty bucket through ``bucket_shapes``).
        ``eval_metric``, ``kvstore``, ``compression``, ``overlap``,
        ``comm_kernels``, ``batch_end_callback`` and ``parallel`` are taken
        as the JAX package takes them and change no program here (a device
        metric and a host one run outside the captured step; an overlapped
        exchange runs only in a multi-worker fit, which is eager).
        ``health`` captures the programs of a ``fit(health=...)``, whose
        steps compute the health statistics, and ``guards`` those of a
        ``fit(guards=...)``.

        ``shard_audit`` (True, or env ``MXNET_TPU_SHARD_AUDIT``) audits
        each program of a ctx list of several devices as ``fit`` would
        (``compression``, ``overlap`` and ``comm_kernels`` make its
        exchange) and raises MXNetError on drift; ``"report"`` collects
        the reports without raising. Returns ``{"programs",
        "wall_seconds", "labels", "shard_audit"}``."""
        del eval_metric, batch_end_callback, parallel
        from .analysis.sharding import shard_audit_enabled

        report_only = shard_audit == "report"
        audit_on = report_only or shard_audit_enabled(shard_audit)
        health_cfg = telemetry_mod.HealthConfig.resolve(health)
        guard_cfg = guards_mod.GuardConfig.resolve(guards)
        if isinstance(kvstore, str) and "dist" in kvstore:
            raise MXNetError(
                "precompile: multi-process kvstore strategies must warm up "
                "inside the launched job (the mesh spans processes); call "
                "precompile there, or rely on the persistent cache")
        t0 = time.perf_counter()
        if data is not None:
            if hasattr(data, "bucket_shapes"):
                programs = [(bk, dict(d), dict(lab))
                            for bk, d, lab in data.bucket_shapes()]
            else:
                programs = [(None, dict(data.provide_data),
                             dict(data.provide_label))]
            base = {**dict(data.provide_data), **dict(data.provide_label)}
        elif data_shapes:
            programs = [(None, dict(data_shapes), dict(label_shapes or {}))]
            base = {**programs[0][1], **programs[0][2]}
        else:
            raise MXNetError("precompile: pass data_shapes (+label_shapes) "
                             "or data=<DataIter>")

        def split(spec):
            if isinstance(spec, tuple) and len(spec) == 2 and \
                    isinstance(spec[0], (tuple, list)):
                return tuple(spec[0]), np.dtype(spec[1])
            return tuple(spec), np.dtype(np.float32)

        pad_policy = compile_mod.PadPolicy.resolve(pad_policy)
        base = {k: split(v)[0] for k, v in base.items()}
        param_names, aux_names = self._init_params(base)
        # fit's batch size: the rows of its batches
        optimizer = self._resolve_optimizer(param_names,
                                            next(iter(base.values()))[0])
        self._optimizer_obj = optimizer
        dev = self._device
        captured = self._eager_reason() is None
        state = snap = None
        if len(self._replicas) == 1:
            # a ctx list's replicas are built by fit (their steps are eager)
            state = self._state_for(
                optimizer, {k: self.arg_params[k] for k in param_names},
                {k: self.aux_params[k] for k in aux_names}, None,
                [k for k in programs[0][1]])
            # the programs of a fit with health on carry its statistics
            state.enable_health(
                telemetry_mod.health.layer_groups(param_names),
                telemetry_mod.health.loss_heads(self.symbol, ()),
                on=health_cfg is not None)
            # and those of a fit(guards=...) carry its guard
            state.set_guard(guard_cfg)
            snap = state.snapshot() if captured else None
        audit_state = None
        if audit_on and len(self._replicas) > 1:
            # the replicas' state and exchange fit would build
            # (mxnet_tpu/model.py:2834-2853), audited and then dropped
            audit_state = self._audit_replicas(
                optimizer, param_names, aux_names, [k for k in programs[0][1]],
                compression, overlap, comm_kernels, health_cfg, guard_cfg)
        labels, shard_reports = [], []
        try:
            for bucket_key, dshapes, lshapes in programs:
                arrays = {}
                for name, spec in {**dshapes, **lshapes}.items():
                    shape, dtype = split(spec)
                    arrays[name] = torch.zeros(
                        shape, device=dev, dtype=getattr(torch, dtype.name))
                if pad_policy is not None:
                    arrays["__num_valid__"] = torch.tensor(
                        next(iter(arrays.values())).shape[0],
                        dtype=torch.int32, device=dev)
                labels.append(self._label("train_step", bucket_key))
                if audit_state is not None:
                    shard_reports.append(self._shard_audit_program(
                        audit_state, arrays, bucket_key, list(dshapes),
                        optimizer._get_lr(), raise_on_error=not report_only))
                key = self._program_key(arrays, bucket_key, pad_policy)
                if not captured:
                    compile_mod.registry().see(labels[-1], key, self._seen,
                                               precompile=True)
                    continue
                if key in state.programs:
                    continue
                # the warm-up step (eager, on zeros), then the capture
                self._run_step(state, arrays, bucket_key, list(dshapes),
                               pad_policy, optimizer._get_lr(), True,
                               precompile=True)
                state.programs[key].captured.capture()
        finally:
            if audit_state is not None:
                # the audited replicas' exchange and state go
                audit_state.grad_sync.close()
                self._train_state = None
        if captured:
            torch.cuda.synchronize(dev)
            state.restore(snap)
            if state.guard is not None:
                state.guard.reset()
        return {"programs": len(programs),
                "wall_seconds": time.perf_counter() - t0, "labels": labels,
                "shard_audit": shard_reports}

    def _audit_replicas(self, optimizer, param_names, aux_names, data_names,
                        compression, overlap, comm_kernels, health_cfg,
                        guard_cfg):
        """The replicas' training state of a fit over this ctx list with
        these exchange settings, for :meth:`precompile`'s shard audit."""
        replicas = self._replicas
        axis = len(replicas)
        spec = comm_mod.CompressionSpec.resolve(compression)
        overlap_cfg = comm_mod.OverlapConfig.resolve(overlap) \
            if spec is not None else None
        plan = None
        if overlap_cfg is not None:
            plan = comm_mod.plan_overlap(
                {k: tuple(self.arg_params[k].shape) for k in param_names},
                spec, axis, max_bytes=overlap_cfg.bucket_bytes,
                symbol=self.symbol)
        params = {k: self.arg_params[k] for k in param_names}
        sync = _GradSync(spec, comm_mod.CommKernelConfig.resolve(comm_kernels),
                         params, axis, self._device, plan=plan,
                         group=comm_mod.ReplicaGroup(
                             [c.torch_device for c in replicas]))
        state = self._state_for(optimizer, params,
                                {k: self.aux_params[k] for k in aux_names},
                                sync, data_names)
        state.enable_health(telemetry_mod.health.layer_groups(param_names),
                            telemetry_mod.health.loss_heads(self.symbol, ()),
                            on=health_cfg is not None)
        state.set_guard(guard_cfg)
        return state

    # -- inference --------------------------------------------------------
    def _fill_missing_args(self, symbol, params, arrays):
        """Zero-fill the arguments an inference batch lacks (the loss heads'
        labels, which their forward ignores)."""
        arg_names = symbol.list_arguments()
        missing = [n for n in arg_names if n not in params and n not in arrays]
        if not missing:
            return arrays
        known = {k: tuple(v.shape) for k, v in arrays.items()}
        known.update({k: tuple(v.shape) for k, v in params.items()
                      if k in arg_names})
        arg_shapes, _, _ = symbol.infer_shape(**known)
        shape_of = dict(zip(arg_names, arg_shapes))
        dev = self._device
        return {**arrays, **{n: torch.zeros(shape_of[n], dtype=torch.float32,
                                            device=dev) for n in missing}}

    def _inference_state(self):
        """The parameters (cast to ``compute_dtype``) and auxiliary states
        the eval programs read, on the device: made once, then refreshed in
        place from ``arg_params``/``aux_params`` at each call, so captured
        eval programs keep reading the same tensors."""
        src_p, src_a = self.arg_params, self.aux_params or {}
        held = self._eval_state

        def same(dst, src):
            return dst.keys() == src.keys() and all(
                tuple(dst[k].shape) == tuple(src[k].shape) for k in src)

        if held is None or not (same(held[0], src_p) and same(held[1], src_a)):
            self._eval_state = (_cast_floats(self._on_device(src_p),
                                             self.compute_dtype),
                                self._on_device(src_a))
            self._eval_progs = {}
            return self._eval_state
        for dst, src in zip(held, (src_p, src_a)):
            for k, v in src.items():
                _assign(dst[k], v)
        return held

    def _eval_forward(self, fn, key, label, params, aux, arrays, captured):
        """One eval forward of program ``key``: replayed from its graph
        (inputs copied into its static buffers) when ``captured``, else
        eager. Returns the outputs; a replay's are copies."""
        compile_mod.registry().see(label, key, self._seen)
        if not captured:
            with torch.inference_mode():
                outs, _ = fn({**params, **arrays}, aux)
            return outs
        prog = self._eval_progs.get(key)
        if prog is None:
            static = {k: torch.empty_like(v) for k, v in arrays.items()}

            def run():
                with torch.no_grad():
                    return fn({**params, **static}, aux)[0]

            prog = self._eval_progs[key] = (static, compile_mod.CapturedProgram(
                run, self._device, label, warmup=1,
                inputs=lambda: [params, aux, static]))
        static, program = prog
        for k, v in arrays.items():
            static[k].copy_(v, non_blocking=True)
        return [o.clone() for o in program()]

    def _inference_batches(self, data_iter, data_names, before=None):
        """Yield (batch, outputs of its valid rows) in eval mode, padding a
        short tail batch up to the first batch's rows; each bucket runs its
        own graph, captured once per program key on a card. ``before(i)``
        runs before batch ``i``'s forward; True runs that forward eager
        (a profile window's batch)."""
        if self.arg_params is None:
            raise MXNetError("model has no parameters; fit() or load first")
        fns = {}
        params, aux = self._inference_state()
        dev = self._device
        reason = self._eager_reason()
        if reason is not None:
            compile_mod.note_eager(reason)
        captured = reason is None
        first_rows = None
        data_iter.reset()
        for i, batch in enumerate(data_iter):
            eager = before is not None and before(i)
            if eager and captured:
                compile_mod.registry().record_eager("profile window")
            key = getattr(batch, "bucket_key", None)
            symbol = self._symbol_for_bucket(key)
            if key not in fns:
                fns[key] = _build_graph_fn(symbol, is_train=False)
            names = getattr(batch, "data_names", data_names)
            arrays = {n: to_tensor(a, dev) for n, a in zip(names, batch.data)}
            rows = int(next(iter(arrays.values())).shape[0])
            first_rows = first_rows or rows
            arrays = self._fill_missing_args(symbol, params,
                                             _pad_rows(arrays, first_rows))
            arrays = _cast_floats(arrays, self.compute_dtype)
            outs = self._eval_forward(
                fns[key], self._program_key(arrays, key, None, train=False),
                self._label("eval_step", key), params, aux, arrays,
                captured and not eager)
            nv = rows - batch.pad
            yield batch, [o[:nv].float() for o in outs]

    def _eval(self, eval_iter, eval_metric, data_names, label_names):
        dev = self._device
        mstate = eval_metric.device_init(dev) \
            if eval_metric.device_supported else None
        for batch, outs in self._inference_batches(eval_iter, data_names):
            nv = outs[0].shape[0]
            labels = [to_tensor(a, dev)[:nv] for a in batch.label]
            if mstate is not None:
                mstate = eval_metric.device_update(mstate, labels, outs)
            else:
                eval_metric.update(labels, outs)
        if mstate is not None:
            eval_metric.absorb_device_state(mstate)

    def predict(self, X, batch_size=128, telemetry=None, profile=None):
        """Run the eval forward over X and concatenate the outputs: one
        numpy array for a single-output net, else a list.

        ``telemetry`` (None: env ``MXNET_TPU_TELEMETRY``; True; a
        ``TelemetryConfig``) records a ``predict_step`` span per batch on
        a fresh StepTimeline at ``self.telemetry``; ``profile`` traces one
        window of batches, run eager with the ranges on, into
        ``self.profile_report`` (mxnet_tpu/model.py:3061-3156)."""
        tcfg = telemetry_mod.TelemetryConfig.resolve(telemetry)
        profile_cfg = telemetry_mod.ProfileConfig.resolve(profile)
        tl = None
        if tcfg is not None and tcfg.timeline:
            tl = telemetry_mod.StepTimeline()
            self.telemetry = tl
        dev = self._device
        prof_session = None
        if profile_cfg is not None:
            prof_session = telemetry_mod.profiling.ProfileSession(
                profile_cfg, layers={n.name for n in self.symbol._topo()
                                     if not n.is_variable},
                num_devices=1, owner="predict", device=dev)
        data_iter = _init_iter(X, None, batch_size, is_train=False)
        data_names = [x[0] for x in data_iter.provide_data]
        ledger_t0 = telemetry_mod.hub().now()
        ledger_tic = time.time()
        spans = {}

        def before(i):
            if tl is not None:
                spans[i] = tl.begin_step(0, i, kind="predict_step")
                spans[i].mark("dispatch")
            return prof_session is not None and \
                (prof_session.pending or prof_session.open) and \
                prof_session.before_step(
                    compile_mod.registry().snapshot()["compiles"])

        chunks = None
        try:
            for i, (_, outs) in enumerate(self._inference_batches(
                    data_iter, data_names, before)):
                span = spans.pop(i, None)
                if prof_session is not None and prof_session.open:
                    prof_session.after_step(outs)
                if span is not None:
                    span.mark("device")
                    _wait_step(dev)
                    span.mark("host")
                if chunks is None:
                    chunks = [[] for _ in outs]
                for lst, o in zip(chunks, outs):
                    lst.append(o.cpu().numpy())
                if span is not None:
                    span.end()
        finally:
            if tl is not None:
                telemetry_mod.clear_current_span()
            if prof_session is not None:
                prof_session.close()  # a short dataset closes its window
                self.profile_report = prof_session.report
            try:
                telemetry_mod.ledger.record_run(
                    "predict", fingerprint=str(self._fingerprint(None)),
                    world_size=1, knobs={"profile": profile_cfg is not None},
                    completed=sys.exc_info()[0] is None, since_ts=ledger_t0,
                    span_name="predict_step",
                    wall_seconds=time.time() - ledger_tic)
            except Exception as e:  # noqa: BLE001 - never mask the run
                logging.warning("telemetry ledger: run record failed: %s", e)
        results = [np.concatenate(lst, axis=0) for lst in chunks]
        return results[0] if len(results) == 1 else results

    def score(self, X, *, y=None, eval_metric="accuracy", batch_size=128):
        """Evaluate a metric over labeled data: a DataIter with labels, or
        an array with ``y=``."""
        if hasattr(X, "provide_data"):
            if y is not None:
                raise MXNetError(
                    "score(): pass labels inside the DataIter, not as y=")
        elif y is None:
            raise MXNetError(
                "score() on a raw array needs labels: score(X, y=labels) — "
                "or pass a DataIter that provides labels")
        data_iter = _init_iter(X, y, batch_size, is_train=False)
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        self._eval(data_iter, eval_metric,
                   [x[0] for x in data_iter.provide_data],
                   [x[0] for x in data_iter.provide_label])
        return eval_metric.get()[1]

    # -- persistence ------------------------------------------------------
    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, optimizer="sgd",
               initializer=None, eval_data=None, eval_metric="accuracy",
               epoch_end_callback=None, batch_end_callback=None,
               kvstore="local", logger=None, batch_size=128, **kwargs):
        """Train a new model from data (reference: model.py:820-878)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer or
                            init_mod.Uniform(0.01), **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, batch_size=batch_size)
        return model


def _as_list(x):
    return x if isinstance(x, list) else [x]
