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

Data-parallel training (``kvstore="dist_sync"``) runs one process per
rank, as the JAX package's multi-process form does: every rank calls
``fit`` on its own rows, rank 0's initial parameters are broadcast, and
``rescale_grad`` is ``1/(batch_size*num_workers)``. After backward the
gradients are summed over the ranks (``comm.compressed_allreduce``, or
``comm.error_feedback_allreduce`` with a lossy ``compression``, whose
residual each rank keeps across steps), float auxiliary states are
averaged over the ranks and device metrics summed. ``comm_kernels`` routes
the quantize stages through the fused kernels.

The batches reach the device through a feed thread
(:class:`_DeviceFeed`, the counterpart of ``_AsyncDeviceFeed``): it draws
up to two batches ahead, copies them into pinned host memory and on to the
card on its own CUDA stream, and the step's stream waits on each batch's
event. ``MXTPU_FEED_PREFETCH=0`` feeds synchronously.

Arguments of ``fit`` that belong to later slices of the port raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import zlib

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
from .base import MXNetError
from .callback import BatchEndParam
from .comm.allreduce import all_reduce_sum, broadcast_
from .context import Context, current_context
from .convert import to_tensor
from .executor import _build_graph_fn

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]

# fit() arguments of later slices -> the ROADMAP item that brings them
_LATER_SLICES = {
    "sharded_checkpoint_dir": "A3 (utils/checkpoint.py)",
    "checkpoint_every_n_steps": "A3 (utils/checkpoint.py)",
    "overlap": "A4 (left from slice 4: comm/overlap.py)",
    "guards": "A6 (resilience/)",
    "elastic": "A6 (resilience/)",
    "controller": "A6 (resilience/)",
    "pad_policy": "A6 (utils/compile.py)",
    "telemetry": "A6 (telemetry/)",
    "health": "A6 (telemetry/)",
    "profile": "A6 (telemetry/)",
    "shard_audit": "A6 (analysis/)",
}


def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _atomic_write(path, writer):
    """Write ``path`` through ``writer(tmp_path)`` at a hidden temporary
    name, record a ``<path>.crc32`` sidecar ({"size", "crc32"}) and commit
    both with ``os.replace``, file first (mxnet_tpu/utils/checkpoint.py:404),
    so a killed save never leaves a torn file that loads."""
    path = os.path.abspath(os.fspath(path))
    tmp = os.path.join(os.path.dirname(path), f".tmp.{os.path.basename(path)}")
    writer(tmp)
    info = {"size": os.path.getsize(tmp), "crc32": _file_crc32(tmp)}
    side_tmp = tmp + ".crc32"
    with open(side_tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    os.replace(side_tmp, path + ".crc32")


def _check_sidecar(path):
    """True when ``path`` matches its CRC sidecar, False when it does not
    (torn or corrupt), None when there is no sidecar (accepted as is)."""
    path = os.path.abspath(os.fspath(path))
    side = path + ".crc32"
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            info = json.load(f)
        return (os.path.getsize(path) == int(info["size"])
                and _file_crc32(path) == int(info["crc32"]))
    except (OSError, ValueError, KeyError, TypeError):
        return False


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (names
    ``arg:<name>`` and ``aux:<name>``), each atomically with a sidecar."""
    _atomic_write(f"{prefix}-symbol.json", lambda tmp: symbol.save(tmp))
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _atomic_write(f"{prefix}-{epoch:04d}.params",
                  lambda tmp: nd.save(tmp, save_dict))
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_checkpoint(prefix, epoch):
    """Load what either package's ``save_checkpoint`` wrote; returns
    ``(symbol, arg_params, aux_params)`` with CPU tensors. A params file
    that fails its sidecar raises."""
    params_path = f"{prefix}-{epoch:04d}.params"
    if _check_sidecar(params_path) is False:
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
    """The data-parallel part of a step, on one rank of ``num_workers``:
    the gradient sum over the ranks (sum semantics; the optimizer's
    ``rescale_grad`` makes it the mean), with this rank's error-feedback
    residual for a lossy ``spec``; the mean of float auxiliary states; the
    sum of device metric accumulators. Registers its wire plan with
    ``comm.comm_stats()`` once and records one step per gradient sync
    (mxnet_tpu/model.py:962-973).

    The gradients are views of one padded f32 buffer, laid out as the
    exchange flattens them (sorted names): :meth:`attach` points every
    parameter's ``.grad`` at its view before backward, and autograd
    accumulates each gradient into it in place. With error feedback the
    buffer is the residual itself, so that accumulation is the residual
    add (``r + g``, the bits of ``g + r``); else it starts at zero. The
    exchange reads the buffer as it is, and :meth:`grads` hands back views
    of its result: neither side copies."""

    LABEL = "train_step:dist_sync"

    def __init__(self, spec, kernels, params, num_workers, device):
        self.spec, self.kernels = spec, kernels
        self.num_workers = num_workers
        self.shapes = {k: tuple(v.shape) for k, v in params.items()}
        size = comm_mod.flat_size(params)
        padded = size if spec is None else \
            comm_mod.padded_flat_size(size, spec, num_workers)
        self.residual = comm_mod.init_error_feedback(
            params, spec, num_workers, device=device)
        self._zeros = None if self.residual is not None else \
            torch.zeros(padded, dtype=torch.float32, device=device)
        self.flat = None  # the buffer backward accumulates into
        comm_mod.registry().register_plan(
            self.LABEL, comm_mod.allreduce_plan(size, num_workers, spec))

    def attach(self, params: dict):
        """Point each parameter's ``.grad`` at its view of the buffer: the
        residual row, or the zeroed buffer."""
        if self.residual is not None:
            self.flat = self.residual[0]
        else:
            self.flat = self._zeros.zero_()
        views = comm_mod.flat_views(self.flat, self.shapes)
        for k, p in params.items():
            p.grad = views[k]

    def grads(self) -> dict:
        """The exchange of the buffer backward filled: the summed gradients
        as views of the exchange's result, the new residual kept."""
        if self.residual is not None:
            out, self.residual = comm_mod.error_feedback_exchange(
                self.flat, self.spec, axis_size=self.num_workers,
                kernels=self.kernels)
        else:
            out = comm_mod.compressed_exchange(
                self.flat, self.spec, axis_size=self.num_workers,
                kernels=self.kernels)
        self.flat = None
        comm_mod.registry().record_step(self.LABEL)
        return comm_mod.flat_views(out, self.shapes)

    def aux(self, aux: dict) -> dict:
        """Float auxiliary states averaged over the ranks (``pmean``), in
        one collective."""
        names = [k for k in sorted(aux) if aux[k].is_floating_point()]
        if not names:
            return aux
        flat = torch.cat([aux[k].reshape(-1).float() for k in names])
        flat = all_reduce_sum(flat) / self.num_workers
        out, off = dict(aux), 0
        for k in names:
            n = aux[k].numel()
            out[k] = flat[off:off + n].reshape(aux[k].shape).to(aux[k].dtype)
            off += n
        return out

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
            self.waits.append(time.perf_counter() - t0)
            yield batch, dev


class _TrainState:
    """The device state of one ``fit``: parameters (autograd leaves),
    auxiliary states and optimizer state, and the training step in its
    phases (forward, backward, the gradient sync of data-parallel
    training, update), so that a caller can time them apart.

    With ``compute_dtype`` the forward runs on copies of the floating
    parameters and of every ``data_names`` input, whatever its type, cast
    to it (labels and auxiliary states stay as they are,
    mxnet_tpu/model.py:669-674); the parameters stay f32 masters, and
    autograd takes their gradients in f32 through the cast.

    ``symbol_for(bucket_key)`` gives the graph of a bucket (bucketing
    trainers); every bucket's graph reads the same parameters."""

    def __init__(self, symbol, optimizer, params, aux, device, sync=None,
                 compute_dtype=None, data_names=(), symbol_for=None):
        self.graph_fn = _build_graph_fn(symbol, is_train=True)
        self._symbol_for = symbol_for
        self._graph_fns = {}
        self.compute_dtype = compute_dtype
        self.data_names = frozenset(data_names)
        self.optimizer = optimizer
        self.grad_sync = sync
        self.params = {k: v.requires_grad_(True) for k, v in params.items()}
        self.aux = aux
        self.opt_state = optimizer.init_state_tree(self.params)
        self.rng = random_mod.generator(device)
        self._loss = None
        self.grads = None

    def forward(self, batch: dict, bucket_key=None, data_names=None):
        """The training forward of ``bucket_key``'s graph (the symbol's
        when None); keeps the sum of the heads for backward and moves the
        auxiliary states (BatchNorm's running stats). ``data_names`` are
        the batch's data inputs (default: the trainer's)."""
        graph_fn = self.graph_fn
        if bucket_key is not None:
            if bucket_key not in self._graph_fns:
                self._graph_fns[bucket_key] = _build_graph_fn(
                    self._symbol_for(bucket_key), is_train=True)
            graph_fn = self._graph_fns[bucket_key]
        names = self.data_names if data_names is None else data_names
        with torch.enable_grad():
            params = _cast_floats(self.params, self.compute_dtype)
            batch = _cast_inputs(batch, self.compute_dtype, names)
            outs, self.aux = graph_fn({**params, **batch}, self.aux, self.rng)
            heads = [o for o in outs if o.requires_grad]
            # seed-ones cotangent: loss heads inject their own gradient
            self._loss = sum(o.float().sum() for o in heads) if heads else None
        return outs

    def backward(self):
        if self.grad_sync is not None:
            # into the sync's flat buffer, through each parameter's .grad
            self.grad_sync.attach(self.params)
            if self._loss is not None:
                torch.autograd.backward(self._loss,
                                        inputs=list(self.params.values()))
            self._loss = None
            return
        names = list(self.params)
        grads = [None] * len(names)
        if self._loss is not None:
            grads = torch.autograd.grad(
                self._loss, [self.params[k] for k in names], allow_unused=True)
        self._loss = None
        # a parameter no head depends on (fix_gamma's gamma) gets zeros
        self.grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                      for k, g in zip(names, grads)}

    def sync(self):
        """Data-parallel training: the gradients summed over the ranks and
        the auxiliary states averaged. A no-op on one device."""
        if self.grad_sync is not None:
            with torch.no_grad():
                self.grads = self.grad_sync.grads()
                self.aux = self.grad_sync.aux(self.aux)

    def update(self, lr):
        with torch.no_grad():
            params, self.opt_state = self.optimizer.apply(
                self.params, self.grads, self.opt_state, lr)
        self.grads = None
        # the per-leaf paths return new tensors; the fused one, the same
        self.params = {k: v if v.requires_grad else v.requires_grad_(True)
                       for k, v in params.items()}


class FeedForward:
    """Model estimator over a loss-headed Symbol (reference: model.py:465).

    ``ctx`` defaults to ``[current_context()]``, which is ``gpu(0)`` outside
    a ``with mt.cpu():`` block; this slice trains on one device.
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
        # called as fn(batch, device_arrays) after each training forward
        self._step_hook = None
        self.feed_waits = []

    def _symbol_for_bucket(self, bucket_key):
        """The graph of one bucket; one symbol here (bucketing trainers
        make one a key)."""
        del bucket_key
        return self.symbol

    @property
    def _device(self) -> torch.device:
        if len(self.ctx) != 1:
            raise NotImplementedError(
                f"FeedForward over {len(self.ctx)} devices in one process is "
                "not ported yet: ROADMAP A4 (left from slice 4: the "
                "single-process multi-device ctx); run one process per "
                "device with kvstore='dist_sync'")
        return self.ctx[0].torch_device

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
        is ignored, as in the JAX package."""
        del work_load_list
        given = dict(sharded_checkpoint_dir=sharded_checkpoint_dir,
                     guards=guards, pad_policy=pad_policy,
                     overlap=overlap, telemetry=telemetry,
                     elastic=elastic, controller=controller, health=health,
                     profile=profile, shard_audit=shard_audit,
                     checkpoint_every_n_steps=checkpoint_every_n_steps)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"fit({name}=...) is not ported yet: ROADMAP "
                    f"{_LATER_SLICES[name]}")
        logger = logger or logging
        dev = self._device
        kv = kvs_mod.create(kvstore, ctx=self.ctx[0]) if kvstore else None
        num_workers = kv.num_workers if kv is not None else 1
        dist_sync = kv is not None and "dist" in kv.type and num_workers > 1
        comm_spec = comm_mod.CompressionSpec.resolve(compression)
        comm_kernels = comm_mod.CommKernelConfig.resolve(comm_kernels)
        if comm_spec is not None and not dist_sync:
            logger.info("compression=%s ignored: single-device training "
                        "moves no gradient bytes over a wire",
                        comm_spec.mode)
            comm_spec = None
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
        params = self._on_device({k: self.arg_params[k] for k in param_names})
        aux = self._on_device({k: self.aux_params[k] for k in aux_names})
        sync = None
        if dist_sync:
            # rank 0's initialization wins, like kvstore.init from rank 0
            # (mxnet_tpu/model.py:1273-1287)
            for k in sorted(params):
                broadcast_(params[k])
            for k in sorted(aux):
                broadcast_(aux[k])
            sync = _GradSync(comm_spec, comm_kernels, params, num_workers,
                             dev)
        state = self._train_state = _TrainState(
            self.symbol, optimizer, params, aux, dev, sync=sync,
            compute_dtype=self.compute_dtype, data_names=data_names,
            symbol_for=self._symbol_for_bucket)
        eval_metric = metric_mod.create(eval_metric)
        device_metric = eval_metric.device_supported and \
            batch_end_callback is None
        cpu = torch.device("cpu")

        def extract(batch):
            arrays = {n: to_tensor(a, cpu) for n, a in zip(
                getattr(batch, "data_names", data_names), batch.data)}
            arrays.update({n: to_tensor(a, cpu) for n, a in zip(
                getattr(batch, "label_names", label_names), batch.label)})
            return arrays

        feed_depth = int(os.environ.get("MXTPU_FEED_PREFETCH", "2"))
        self.feed_waits = []
        num_update = 0
        for epoch in range(self.begin_epoch, self.num_epoch):
            tic = time.time()
            eval_metric.reset()
            mstate = eval_metric.device_init(dev) if device_metric else None
            nbatch = 0
            train_data.reset()
            feed = _DeviceFeed(train_data, extract, dev, depth=feed_depth) \
                if feed_depth > 0 else _SyncFeed(train_data, extract, dev)
            try:
                for batch, arrays in feed:
                    b_lnames = getattr(batch, "label_names", label_names)
                    lr = optimizer._get_lr()
                    optimizer.num_update = num_update
                    outs = state.forward(
                        arrays, getattr(batch, "bucket_key", None),
                        getattr(batch, "data_names", None))
                    if self._step_hook is not None:
                        self._step_hook(batch, arrays)
                    state.backward()
                    state.sync()
                    state.update(lr)
                    num_update += 1
                    labels = [arrays[n] for n in b_lnames]
                    preds = [o.detach().float() for o in outs[:len(labels)]]
                    if device_metric:
                        mstate = eval_metric.device_update(mstate, labels,
                                                           preds)
                    else:
                        eval_metric.update(labels, preds)
                    nbatch += 1
                    if batch_end_callback is not None:
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric)
                        for cb in _as_list(batch_end_callback):
                            cb(param)
            finally:
                feed.close()
                self.feed_waits.extend(feed.waits)
            if device_metric:
                if sync is not None:
                    mstate = sync.metric(mstate)
                eval_metric.absorb_device_state(mstate)
            name, value = eval_metric.get()
            logger.info("Epoch[%d] Train-%s=%f", epoch, name, value)
            logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            # write back, so callbacks and checkpoints see this epoch's state
            self.arg_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in state.params.items()}
            self.aux_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in state.aux.items()}
            if eval_data is not None:
                eval_metric.reset()
                eval_iter = _init_iter(eval_data[0], eval_data[1], batch_size,
                                       is_train=False) \
                    if isinstance(eval_data, tuple) else eval_data
                self._eval(eval_iter, eval_metric, data_names, label_names)
                name, value = eval_metric.get()
                logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, self.arg_params, self.aux_params)

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

    def _inference_batches(self, data_iter, data_names):
        """Yield (batch, outputs of its valid rows) in eval mode, padding a
        short tail batch up to the first batch's rows; each bucket runs its
        own graph."""
        if self.arg_params is None:
            raise MXNetError("model has no parameters; fit() or load first")
        fns = {}
        params = _cast_floats(self._on_device(self.arg_params),
                              self.compute_dtype)
        aux = self._on_device(self.aux_params or {})
        dev = self._device
        first_rows = None
        data_iter.reset()
        for batch in data_iter:
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
            with torch.inference_mode():
                outs, _ = fns[key]({**params, **arrays}, aux)
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

    def predict(self, X, batch_size=128):
        """Run the eval forward over X and concatenate the outputs: one
        numpy array for a single-output net, else a list."""
        data_iter = _init_iter(X, None, batch_size, is_train=False)
        data_names = [x[0] for x in data_iter.provide_data]
        chunks = None
        for _, outs in self._inference_batches(data_iter, data_names):
            if chunks is None:
                chunks = [[] for _ in outs]
            for lst, o in zip(chunks, outs):
                lst.append(o.cpu().numpy())
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
