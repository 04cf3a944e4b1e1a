"""Module API: the intermediate-level trainer with an explicit lifecycle.

Counterpart of ``mxnet_tpu/module.py``: ``bind -> init_params ->
init_optimizer``, then ``forward / backward / update`` per step under the
caller's control, with ``fit``, ``score`` and ``predict`` driving them, over
the port's ``Executor`` and the optimizer's updater contract::

    mod = mt.mod.Module(symbol, context=mt.cpu())
    mod.fit(train_iter, num_epoch=8, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    mod.score(val_iter, "accuracy")

``BucketingModule`` keeps one executor a bucket key; every bucket's
executor holds the default bucket's parameter and gradient tensors
themselves, so the updater's in-place write is seen by every bucket.
On a card ``fit`` captures each executor's training forward and backward
as a pair of CUDA graphs before its first step (one pair a bucket), and
every step replays it; the updater writes the parameters in place, where
the graphs read them.
``context`` defaults to ``current_context()``: the card, unless the caller
passes ``mt.cpu()``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import initializer as init_mod
from . import metric as metric_mod
from . import optimizer as opt_mod
from .base import MXNetError
from .callback import BatchEndParam
from .context import current_context
from .convert import to_tensor
from .executor import Executor
from .utils import compile as compile_mod
from .model import _as_list, load_checkpoint, save_checkpoint

__all__ = ["Module", "BucketingModule"]


class Module:
    """Intermediate-level trainer over a loss-headed Symbol."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), context=None,
                 logger=None):
        self._symbol = symbol
        self._data_names = tuple(data_names)
        self._label_names = tuple(label_names or ())
        self._context = context if context is not None else current_context()
        self._logger = logger or logging
        self._exec = None
        self._capturing = False  # fit captures each executor's pair
        self._updater = None
        self._optimizer = None
        self._monitor = None
        self._pending_params = None
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    @property
    def symbol(self):
        return self._symbol

    # -- lifecycle --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             grad_req="write"):
        """Allocate the buffers and bind the executor; ``data_shapes`` and
        ``label_shapes`` are ``[(name, shape), ...]`` (an iterator's
        ``provide_data`` / ``provide_label``). Declared label names stay
        inputs even without ``label_shapes`` (their shapes are inferred),
        so the optimizer never takes them for parameters."""
        shapes = dict(data_shapes)
        if label_shapes:
            shapes.update(dict(label_shapes))
        arg_names = self._symbol.list_arguments()
        missing_labels = [n for n in self._label_names
                          if n in arg_names and n not in shapes]
        if missing_labels:
            arg_shapes, _, _ = self._symbol.infer_shape(**shapes)
            inferred = dict(zip(arg_names, arg_shapes))
            for n in missing_labels:
                shapes[n] = inferred[n]
        if not for_training:
            grad_req = "null"
        if grad_req != "null":  # inputs and labels carry no gradient
            grad_req = {n: grad_req for n in arg_names if n not in shapes}
        self._exec = self._symbol.simple_bind(self._context,
                                              grad_req=grad_req, **shapes)
        self._shapes = shapes
        self.binded = True
        self.for_training = for_training
        return self

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Fill the parameters in place: from ``arg_params`` /
        ``aux_params`` where given (a missing argument raises unless
        ``allow_missing``; a missing auxiliary state keeps its value), else
        by the initializer (default ``Uniform(0.01)``)."""
        if not self.binded:
            raise MXNetError("init_params requires bind() first")
        if self.params_initialized and not force_init:
            return self
        if arg_params is None and aux_params is None and self._pending_params:
            arg_params, aux_params = self._pending_params  # Module.load
        initializer = initializer if initializer is not None \
            else init_mod.Uniform(0.01)
        with torch.no_grad():
            for name, arr in self._exec.arg_dict.items():
                if name in self._shapes:
                    continue
                if arg_params is not None and name in arg_params:
                    arr.copy_(to_tensor(arg_params[name], arr.device))
                elif arg_params is not None and not allow_missing:
                    raise MXNetError(
                        f"init_params: {name!r} missing from arg_params "
                        "(pass allow_missing=True to initialize it)")
                else:
                    initializer(name, arr)
            for name, arr in self._exec.aux_dict.items():
                if aux_params is not None and name in aux_params:
                    arr.copy_(to_tensor(aux_params[name], arr.device))
                elif aux_params is None:
                    initializer(name, arr)
        self.params_initialized = True
        return self

    def init_optimizer(self, optimizer="sgd", optimizer_params=None,
                       force_init=False):
        if not self.params_initialized:
            raise MXNetError("init_optimizer requires init_params() first")
        if self.optimizer_initialized and not force_init:
            return self
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._param_names = [n for n in self._symbol.list_arguments()
                             if n not in self._shapes]
        optimizer.arg_names = list(self._param_names)
        self.optimizer_initialized = True
        return self

    # -- per step ---------------------------------------------------------
    @staticmethod
    def _feed(data_batch, data_names, label_names, inputs):
        """The batch's arrays by name; labels only where ``inputs`` has
        them."""
        feed = dict(zip(data_names, data_batch.data))
        labels = getattr(data_batch, "label", None) or []
        feed.update((n, a) for n, a in zip(label_names, labels) if n in inputs)
        return feed

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feed = self._feed(
            data_batch, getattr(data_batch, "data_names", self._data_names),
            getattr(data_batch, "label_names", self._label_names),
            self._shapes)
        self._capture_pair(is_train)
        self._exec.forward(is_train=is_train, **feed)
        return self

    def _capture_pair(self, is_train):
        """Inside ``fit`` on a card: capture the executor's forward and
        backward pair before its first training forward, so every step
        replays it (``Executor._capture_train``)."""
        if is_train and self._capturing and self._exec._pair is None:
            self._exec._capture_train()

    def backward(self):
        self._exec.backward()
        return self

    def install_monitor(self, mon):
        """Attach a Monitor to the bound executor (BucketingModule
        re-installs it on the executor each forward selects)."""
        if not self.binded:
            raise MXNetError("install_monitor requires bind() first")
        self._monitor = mon
        mon.install(self._exec)
        return self

    def update(self, kvstore=None):
        """One optimizer step of every bound parameter from its gradient.
        With ``kvstore`` each gradient goes through the store first (push
        i, pull i: merged or summed over the workers, update on the
        worker); a store that runs an updater of its own is refused, since
        its pull returns weights."""
        if not self.optimizer_initialized:
            raise MXNetError("update requires init_optimizer() first")
        if kvstore is not None and (
                getattr(kvstore, "type", "") == "dist_async"
                or getattr(kvstore, "_updater", None) is not None):
            raise MXNetError(
                "Module.update routes gradients through the store "
                "(update-on-worker); this kvstore runs an updater on the "
                "store side (update-on-kvstore) — its pull returns "
                "weights, not gradients. Use FeedForward.fit for "
                "dist_async / set_optimizer stores.")
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            if kvstore is not None:
                kvstore.push(i, grad)
                kvstore.pull(i, grad)
            self._updater(i, grad, self._exec.arg_dict[name])
        return self

    def get_outputs(self):
        return self._exec.outputs

    def update_metric(self, eval_metric, labels, pad=0):
        """Feed the step's outputs to the metric, without the ``pad``
        wrapped rows of a last partial batch."""
        outs = self._exec.outputs[:max(1, len(labels))]
        if pad:
            keep = len(labels[0]) - pad if labels else None
            labels = [lab[:keep] for lab in labels]
            outs = [o[:keep] for o in outs]
        eval_metric.update(labels, outs)

    # -- parameters -------------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)`` as copies on the CPU."""
        arg = {n: a.detach().to("cpu", copy=True)
               for n, a in self._exec.arg_dict.items() if n not in self._shapes}
        aux = {n: a.detach().to("cpu", copy=True)
               for n, a in self._exec.aux_dict.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=True, force_init=True)

    def save_checkpoint(self, prefix, epoch):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)

    @staticmethod
    def load(prefix, epoch, **kwargs):
        symbol, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(symbol, **kwargs)
        mod._pending_params = (arg, aux)
        return mod

    # -- high level -------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="accuracy",
            initializer=None, optimizer="sgd", optimizer_params=None,
            num_epoch=1, kvstore=None, batch_end_callback=None,
            epoch_end_callback=None):
        """Bind, initialise and train in one call; ``kvstore`` (a KVStore)
        routes the gradients through the store each step (see
        :meth:`update`)."""
        if not self.binded:
            self.bind(train_data.provide_data, train_data.provide_label)
        if not self.params_initialized:
            self.init_params(initializer)
        fresh_optimizer = not self.optimizer_initialized
        if fresh_optimizer:
            self.init_optimizer(optimizer, optimizer_params)
        if kvstore is not None and kvstore.num_workers > 1 and \
                fresh_optimizer:
            # the pulled gradient is the sum over the workers
            self._optimizer.rescale_grad /= kvstore.num_workers
        if kvstore is not None and not getattr(self, "_kv_ready", False):
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._exec.arg_dict[name])
            if kvstore.num_workers > 1:
                # rank 0's initialisation wins
                from .comm.allreduce import broadcast_

                for name in self._param_names:
                    broadcast_(self._exec.arg_dict[name])
            self._kv_ready = True
        eval_metric = metric_mod.create(eval_metric)
        # on a card each executor's forward and backward replay a captured
        # pair (one a bucket); the eager cases count their reason
        reason = self._exec.train_reason()
        if reason is not None:
            compile_mod.note_eager(reason, self._logger)
        self._capturing = reason is None
        for epoch in range(num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for batch in train_data:
                self.forward(batch, is_train=True)
                self.backward()
                self.update(kvstore=kvstore)
                self.update_metric(eval_metric, batch.label,
                                   pad=getattr(batch, "pad", 0))
                nbatch += 1
                if batch_end_callback is not None:
                    p = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric)
                    for cb in _as_list(batch_end_callback):
                        cb(p)
            name, value = eval_metric.get()
            self._logger.info("Epoch[%d] Train-%s=%f", epoch, name, value)
            self._logger.info("Epoch[%d] Time cost=%.3f", epoch,
                              time.time() - tic)
            if eval_data is not None:
                name, value = self.score(eval_data, eval_metric)
                self._logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                                  value)
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self._symbol, arg, aux)
        return self

    def score(self, eval_data, eval_metric="accuracy"):
        eval_metric = metric_mod.create(eval_metric) \
            if isinstance(eval_metric, str) else eval_metric
        eval_metric.reset()
        eval_data.reset()
        for batch in eval_data:
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label,
                               pad=getattr(batch, "pad", 0))
        return eval_metric.get()

    def predict(self, eval_data):
        """The first output over the iterator, stacked, without pad rows."""
        outs = []
        eval_data.reset()
        for batch in eval_data:
            self.forward(batch, is_train=False)
            pad = getattr(batch, "pad", 0)
            arr = self._exec.outputs[0].float().cpu().numpy()
            outs.append(arr[:len(arr) - pad] if pad else arr)
        return np.concatenate(outs, axis=0)


class BucketingModule(Module):
    """A Module over a symbol factory, ``sym_gen(bucket_key) -> Symbol``:
    one executor a bucket key, each holding the default bucket's parameter,
    gradient and auxiliary tensors themselves (the same objects), with
    fresh input buffers. Batches carry ``bucket_key``, ``data_names`` and
    ``label_names`` (``BucketSentenceIter``'s protocol). Every bucket's
    parameters must match the default bucket's in name and shape."""

    def __init__(self, sym_gen, default_bucket_key, context=None,
                 logger=None):
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        super().__init__(sym_gen(default_bucket_key), data_names=(),
                         label_names=(), context=context, logger=logger)
        self._bucket_execs = {}

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             grad_req="write"):
        super().bind(data_shapes, label_shapes, for_training, grad_req)
        self._grad_req = grad_req
        self._bucket_execs = {self._default_key: self._exec}
        self._default_exec = self._exec
        return self

    def _executor_for(self, key, shapes):
        """Bind ``key``'s symbol over the default executor's tensors."""
        sym = self._sym_gen(key)
        arg_names = sym.list_arguments()
        known = dict(shapes)
        for n in arg_names:
            if n not in known and n in self._default_exec.arg_dict:
                known[n] = tuple(self._default_exec.arg_dict[n].shape)
        arg_shapes, _, aux_shapes = sym.infer_shape(**known)
        dev = self._context.torch_device
        args, grads, reqs = {}, {}, {}
        for n, s in zip(arg_names, arg_shapes):
            if n in shapes:
                args[n] = torch.zeros(s, dtype=torch.float32, device=dev)
                reqs[n] = "null"
                continue
            shared = self._default_exec.arg_dict.get(n)
            if shared is None or tuple(shared.shape) != tuple(s):
                raise MXNetError(
                    f"bucket {key!r}: parameter {n!r} "
                    + ("is absent from" if shared is None else
                       f"has shape {tuple(s)} != "
                       f"{tuple(shared.shape)} in")
                    + " the default bucket — buckets must share one "
                    "parameter set")
            args[n] = shared
            g = self._default_exec.grad_dict.get(n)
            if g is not None:
                grads[n] = g
            reqs[n] = self._grad_req if g is not None else "null"
        aux = {}
        for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
            shared = self._default_exec.aux_dict.get(n)
            if shared is None or tuple(shared.shape) != tuple(s):
                raise MXNetError(
                    f"bucket {key!r}: aux state {n!r} does not match the "
                    "default bucket's — buckets must share one state set")
            aux[n] = shared
        return Executor(sym, self._context, args, grads, reqs, aux)

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_key)
        labels = getattr(data_batch, "label", None) or []
        label_names = getattr(data_batch, "label_names", ()) if labels \
            else ()
        if key not in self._bucket_execs:
            shapes = dict(zip(data_batch.data_names,
                              [tuple(a.shape) for a in data_batch.data]))
            shapes.update(zip(label_names, [tuple(a.shape) for a in labels]))
            self._bucket_execs[key] = self._executor_for(key, shapes)
        self._exec = self._bucket_execs[key]
        if self._monitor is not None:
            self._monitor.install(self._exec)
        if is_train is None:
            is_train = self.for_training
        feed = self._feed(data_batch, data_batch.data_names, label_names,
                          self._exec.arg_dict)
        self._capture_pair(is_train)
        self._exec.forward(is_train=is_train, **feed)
        return self

    def update(self, kvstore=None):
        # the gradients sit in the shared tensors, whichever bucket ran
        current = self._exec
        self._exec = self._default_exec
        try:
            return super().update(kvstore=kvstore)
        finally:
            self._exec = current
