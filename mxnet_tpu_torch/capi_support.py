"""Python side of the flat C API.

Counterpart of ``mxnet_tpu/capi_support.py`` (reference: include/mxnet/
c_api.h, the ``MX*`` functions of src/c_api/c_api.cc). The C library
(``native/mxtpu_capi.cc``, built by :func:`native.capi.build_capi`) embeds
CPython, or joins the running interpreter, and forwards every call to one
:class:`CApi` method here. Handles that cross the C boundary are boxed
Python objects (NDArray, Symbol, the bound executor, iterators, KVStore,
RecordIO); this module sees raw pointers only for caller-owned buffers,
which arrive as integer addresses and are touched through ctypes. Every
method returns plain scalars, tuples, lists or bytes, so the C layer stays
uniform glue; an exception becomes -1 in C with its message in
``MXGetLastError``.

Devices. ``dev_type`` 1 is ``cpu``, 2 the card (``gpu``) and 3
``cpu_pinned``, the reference's codes (base.h:92-97); the JAX package maps
3 to ``cpu`` and the accelerator slot to its TPU. A caller that asks for
``dev_type`` 2 where there is no CUDA gets the error of
:func:`context.gpu`, which names CUDA: the array is never made on the CPU
instead. ``MXNDArrayGetContext`` reports the code of the array's device
(2 for an array on the card). Entry points that take no context make
their arrays where the JAX package's do, on the host, here ``cpu()``:
``MXNDArrayCreateNone``, ``MXNDArrayLoad`` (``nd.load`` returns CPU
tensors), ``MXNDArrayLoadFromRawBytes`` and a data iterator's
``MXDataIterGetData`` / ``MXDataIterGetLabel`` (batches hold CPU tensors).

An executor bound through ``MXExecutorBind`` reads its arguments through
the caller's NDArray handles, as the JAX package's does, and writes its
gradients and auxiliary states to theirs. It runs on copies of the bound
arrays: an NDArray rebinds to a new tensor on every write
(``MXNDArraySyncCopyFromCPU``, ``MXFuncInvoke``), so a handle rebound since
the last call is copied into the executor's tensor before the next one,
and the gradient and auxiliary handles are rebound to copies of what the
executor wrote, never aliasing a tensor it writes in place.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import io as io_mod
from . import ndarray as nd
from . import random as random_mod
from . import recordio as rio
from . import symbol as sym_mod
from .base import MXNetError
from .context import Context, cpu, cpu_pinned, gpu
from .engine import engine
from .executor import Executor
from .kvstore import create as kv_create_fn
from .ndarray import NDArray
from .ops.registry import OPS

__all__ = ["CApi"]


def _ctx(dev_type: int, dev_id: int) -> Context:
    """The reference's dev_type codes: 1 cpu, 2 gpu, 3 cpu_pinned; any other
    code is refused."""
    make = {1: cpu, 2: gpu, 3: cpu_pinned}.get(int(dev_type))
    if make is None:
        raise MXNetError(f"unknown dev_type {dev_type} (1 cpu, 2 gpu, "
                         "3 cpu_pinned)")
    return make(int(dev_id))


_DEV_TYPES = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

# the reference's 18 registered NDArray functions (ndarray.cc:601-652)
# plus the unary TBlob ops, with their FFI arity metadata
# (num_use_vars, num_scalars, num_mutate_vars, accept_empty_mutate)
_FUNCTIONS: dict = {
    "_set_value": (0, 1, 1, False),
    "_plus": (2, 0, 1, True),
    "_minus": (2, 0, 1, True),
    "_mul": (2, 0, 1, True),
    "_div": (2, 0, 1, True),
    "dot": (2, 0, 1, True),
    "_onehot_encode": (2, 0, 1, False),
    "choose_element_0index": (2, 0, 1, True),
    "_plus_scalar": (1, 1, 1, True),
    "_minus_scalar": (1, 1, 1, True),
    "_mul_scalar": (1, 1, 1, True),
    "_div_scalar": (1, 1, 1, True),
    "_rminus_scalar": (1, 1, 1, True),
    "_rdiv_scalar": (1, 1, 1, True),
    "_copyto": (1, 0, 1, False),
    "_random_uniform": (0, 2, 1, False),
    "_random_gaussian": (0, 2, 1, False),
    "clip": (1, 2, 1, True),
    "square": (1, 0, 1, True),
    "sqrt": (1, 0, 1, True),
    "exp": (1, 0, 1, True),
    "log": (1, 0, 1, True),
    "norm": (1, 0, 1, True),
}


class _BoundExecutor:
    """The executor behind an ``ExecutorHandle``: an :class:`Executor` over
    private copies of the caller's arrays, kept in step with the handles.

    An NDArray is never written in place (a write rebinds it), so a handle
    that holds the tensor it was last given is unchanged: only a rebound
    handle is copied into the executor before a call. After a training
    forward the auxiliary handles, and after ``backward`` the gradient
    handles, are rebound to copies of what the executor wrote in place."""

    def __init__(self, executor, args, grads, aux):
        self.executor = executor
        names = executor._symbol.list_arguments()
        self._groups = (
            (list(zip(names, args)), executor.arg_dict),
            ([(n, g) for n, g in zip(names, grads) if g is not None],
             executor.grad_dict),
            (list(zip(executor._symbol.list_auxiliary_states(), aux)),
             executor.aux_dict))
        self._given = {(i, n): a.data for i, (group, _) in
                       enumerate(self._groups) for n, a in group}
        self._outputs = []

    def _sync_in(self):
        with torch.no_grad():
            for i, (group, held) in enumerate(self._groups):
                for name, array in group:
                    if array.data is not self._given[(i, name)]:
                        held[name].copy_(array.data)
                        self._given[(i, name)] = array.data

    def _sync_out(self, i):
        group, held = self._groups[i]
        for name, array in group:
            t = held[name]
            array._set_data(t.clone() if t.device == array.data.device else t)
            self._given[(i, name)] = array.data

    def forward(self, is_train):
        self._sync_in()
        outs = self.executor.forward(is_train=bool(is_train))
        if is_train:
            self._sync_out(2)
        self._outputs = [NDArray(o, self.executor._ctx) for o in outs]

    def backward(self, head_grads):
        self._sync_in()
        self.executor.backward([g.data for g in head_grads]
                               if head_grads else None)
        self._sync_out(1)

    @property
    def outputs(self):
        return list(self._outputs)


class CApi:
    """Instance methods = the C API, one per MX* entry point."""

    def __init__(self):
        # host mirrors handed out by MXNDArrayGetData: identity -> (owner,
        # buffer). Holding the owner pins both until the C layer drops the
        # last handle on it (ndarray_drop_host_view).
        self._host_views: dict = {}

    # -- ndarray ------------------------------------------------------------
    def ndarray_create_none(self):
        return NDArray(np.zeros((1,), np.float32), cpu())

    def ndarray_create(self, shape, dev_type, dev_id, delay_alloc):
        return nd.zeros(tuple(int(s) for s in shape), _ctx(dev_type, dev_id))

    def ndarray_save(self, fname, handles, names):
        if names:
            nd.save(fname, dict(zip(names, handles)))
        else:
            nd.save(fname, list(handles))

    def ndarray_load(self, fname):
        loaded = nd.load(fname)
        if isinstance(loaded, dict):
            return ([NDArray(t, cpu()) for t in loaded.values()],
                    list(loaded.keys()))
        return [NDArray(t, cpu()) for t in loaded], []

    def ndarray_save_raw(self, array) -> bytes:
        a = array.asnumpy().astype(np.float32)
        shape = np.asarray(a.shape, np.int64)
        return (np.asarray([len(a.shape)], np.int64).tobytes()
                + shape.tobytes() + a.tobytes())

    def ndarray_load_raw(self, buf: bytes):
        ndim = int(np.frombuffer(buf[:8], np.int64)[0])
        shape = tuple(np.frombuffer(buf[8:8 + 8 * ndim], np.int64).tolist())
        data = np.frombuffer(buf[8 + 8 * ndim:], np.float32).reshape(shape)
        return NDArray(data.copy(), cpu())

    def ndarray_sync_copy_from(self, array, src_addr, size):
        src = np.ctypeslib.as_array(
            (ctypes.c_float * int(size)).from_address(int(src_addr)))
        array[:] = src.reshape(array.shape).copy()

    def ndarray_sync_copy_to(self, array, dst_addr, size):
        host = np.ascontiguousarray(array.asnumpy().astype(np.float32))
        if host.size != int(size):
            raise MXNetError(
                f"SyncCopyToCPU: destination holds {size} floats, array "
                f"has {host.size}")
        ctypes.memmove(int(dst_addr), host.ctypes.data, host.nbytes)

    def ndarray_wait_to_read(self, array):
        array.wait_to_read()

    def ndarray_wait_all(self):
        engine().wait_for_all()
        nd.waitall()

    def ndarray_slice(self, array, lo, hi):
        return array[int(lo):int(hi)]

    def ndarray_shape(self, array):
        return tuple(int(s) for s in array.shape)

    def ndarray_data_ptr(self, array):
        """A host mirror of the array as f32, kept alive while a handle on
        the array lives (the reference returns a pointer into the CPU
        tensor, c_api.cc MXNDArrayGetData). Repeat calls refresh the same
        buffer in place, so pointers handed out earlier stay valid and
        current; MXNDArrayFree drops it through
        :meth:`ndarray_drop_host_view`. For an array on the card the mirror
        is a copy from the device: writes through the pointer do not reach
        the card (nor, for that matter, a CPU array, which the mirror copies
        too), as they do not reach a TPU array in the JAX package."""
        host = np.ascontiguousarray(array.asnumpy().astype(np.float32))
        prev = self._host_views.get(id(array))
        if prev is not None and prev[1].shape == host.shape:
            np.copyto(prev[1], host)
            return prev[1].ctypes.data
        self._host_views[id(array)] = (array, host)
        return host.ctypes.data

    def ndarray_drop_host_view(self, obj):
        """Called by MXNDArrayFree when the last handle boxing ``obj`` dies
        (the C side counts live boxes per object, g_box_counts in
        mxtpu_capi.cc). Non-NDArray ids simply miss."""
        self._host_views.pop(id(obj), None)

    def ndarray_context(self, array):
        c = array.context
        return _DEV_TYPES[c.device_type], c.device_id

    # -- registered functions ------------------------------------------------
    def list_functions(self):
        return [f for f in _FUNCTIONS if hasattr(nd, f) or f == "_set_value"]

    def func_info(self, name):
        nuse, nscalar, nmutate, accept_empty = _FUNCTIONS[name]
        fn = getattr(nd, name, None)
        doc = (fn.__doc__ or "").strip() if fn else ""
        return name, doc, nuse, nscalar, nmutate

    def func_describe(self, name):
        return _FUNCTIONS[name][:3] + (1 if _FUNCTIONS[name][3] else 0,)

    def func_invoke(self, name, use_vars, scalars, mutate_vars):
        if name == "_set_value":
            mutate_vars[0][:] = float(scalars[0])
            return
        if name == "_copyto":
            use_vars[0].copyto(mutate_vars[0])
            return
        if name == "_random_uniform":
            random_mod.uniform(float(scalars[0]), float(scalars[1]),
                               out=mutate_vars[0])
            return
        if name == "_random_gaussian":
            random_mod.normal(float(scalars[0]), float(scalars[1]),
                              out=mutate_vars[0])
            return
        if name == "_onehot_encode":
            # arity (2, 0, 1): use=(indices, out), mutate=(out,) -- the
            # second use var IS the output buffer (reference
            # ndarray_function.h OneHotEncode semantics)
            nd.onehot_encode(use_vars[0], mutate_vars[0])
            return
        fn = getattr(nd, name)
        out = mutate_vars[0] if mutate_vars else None
        args = list(use_vars) + [float(s) for s in scalars]
        fn(*args, out=out)

    # -- operators / symbols -------------------------------------------------
    def list_ops(self):
        return sorted({cls.op_name for cls in OPS._entries.values()})

    def op_info(self, opname):
        prop_cls = OPS.get(opname)
        doc = (prop_cls.__doc__ or "").strip()
        names, types, descs = [], [], []
        for pname, spec in getattr(prop_cls, "params", {}).items():
            names.append(pname)
            types.append(repr(spec[0]))
            descs.append(spec[2] if len(spec) > 2 else "")
        return opname, doc, names, types, descs, ""

    def symbol_create_atomic(self, opname, keys, vals):
        OPS.get(opname)  # raises for unknown operators
        return ("__atomic__", opname,
                {k: self._parse_iter_val(v) for k, v in zip(keys, vals)})

    def symbol_create_variable(self, name):
        return sym_mod.Variable(name)

    def symbol_create_group(self, symbols):
        return sym_mod.Group(list(symbols))

    def symbol_from_file(self, fname):
        return sym_mod.load(fname)

    def symbol_from_json(self, js):
        return sym_mod.load_json(js)

    def symbol_save_file(self, symbol, fname):
        symbol.save(fname)

    def symbol_to_json(self, symbol):
        return symbol.tojson()

    def symbol_copy(self, symbol):
        return sym_mod.load_json(symbol.tojson())

    def symbol_print(self, symbol):
        return symbol.debug_str()

    def symbol_list_arguments(self, symbol):
        return list(symbol.list_arguments())

    def symbol_list_outputs(self, symbol):
        return list(symbol.list_outputs())

    def symbol_list_aux(self, symbol):
        return list(symbol.list_auxiliary_states())

    def symbol_get_internals(self, symbol):
        return symbol.get_internals()

    def symbol_get_output(self, symbol, index):
        return symbol[int(index)]

    def symbol_compose(self, symbol, name, keys, args):
        """Reference two-step creation: CreateAtomicSymbol then Compose
        (c_api.cc MXSymbolCompose). Atomic records compose into a real
        Symbol; composing an existing symbol is refused."""
        if isinstance(symbol, tuple) and symbol and symbol[0] == "__atomic__":
            _, opname, params = symbol
            kwargs = dict(params)
            if keys:
                kwargs.update(zip(keys, args))
                pos = []
            else:
                pos = list(args)
            return sym_mod._create(opname, *pos, name=name or None, **kwargs)
        raise MXNetError(
            "MXSymbolCompose on an already-composed symbol is not supported: "
            "compose at creation (CreateAtomicSymbol + Compose) like the "
            "reference bindings do")

    def symbol_infer_shape(self, symbol, names, shapes):
        if isinstance(symbol, tuple) and symbol and symbol[0] == "__atomic__":
            raise MXNetError("infer_shape requires a composed symbol")
        kwargs = {n: tuple(int(x) for x in s) for n, s in zip(names, shapes)}
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            return [], [], [], 0
        return ([tuple(s) for s in arg_shapes],
                [tuple(s) for s in out_shapes],
                [tuple(s) for s in aux_shapes], 1)

    # -- executor ------------------------------------------------------------
    _GRAD_REQ = {0: "null", 1: "write", 2: "write", 3: "add"}  # 2=inplace

    def executor_bind(self, symbol, dev_type, dev_id, args, grads, reqs, aux):
        arg_names = symbol.list_arguments()
        req_map = {n: self._GRAD_REQ[int(r)] for n, r in zip(arg_names, reqs)}
        grad_map = {n: g.data.clone() for n, g in zip(arg_names, grads)
                    if g is not None}
        aux_names = symbol.list_auxiliary_states()
        executor = Executor(symbol, _ctx(dev_type, dev_id),
                            {n: a.data.clone() for n, a in zip(arg_names, args)},
                            grad_map, req_map,
                            {n: a.data.clone() for n, a in zip(aux_names, aux)})
        return _BoundExecutor(executor, args, grads, aux)

    def executor_forward(self, executor, is_train):
        executor.forward(is_train)

    def executor_backward(self, executor, head_grads):
        executor.backward(list(head_grads) if head_grads else None)

    def executor_outputs(self, executor):
        return executor.outputs

    def executor_print(self, executor):
        return executor.executor.debug_str()

    # -- data iterators ------------------------------------------------------
    _ITERS = ("MNISTIter", "ImageRecordIter", "CSVIter", "NDArrayIter")

    def list_data_iters(self):
        return [n for n in self._ITERS if hasattr(io_mod, n)]

    def data_iter_create(self, name, keys, vals):
        cls = getattr(io_mod, name)
        kwargs = {k: self._parse_iter_val(v) for k, v in zip(keys, vals)}
        it = cls(**kwargs)
        it._capi_batch = None
        return it

    @staticmethod
    def _parse_iter_val(v):
        s = str(v)
        if s.lower() in ("true", "false"):
            return s.lower() == "true"
        for conv in (int, float):
            try:
                return conv(s)
            except ValueError:
                pass
        if s.startswith("(") and s.endswith(")"):
            inner = s[1:-1].strip().rstrip(",")
            if inner:
                return tuple(int(float(x)) for x in inner.split(","))
            return ()
        return s

    def data_iter_next(self, it):
        try:
            it._capi_batch = next(it)
            return 1
        except StopIteration:
            it._capi_batch = None
            return 0

    def data_iter_before_first(self, it):
        it.reset()
        it._capi_batch = None

    def data_iter_get_data(self, it):
        return NDArray(it._capi_batch.data[0], cpu())

    def data_iter_get_label(self, it):
        return NDArray(it._capi_batch.label[0], cpu())

    def data_iter_get_pad(self, it):
        return int(it._capi_batch.pad or 0)

    # -- kvstore -------------------------------------------------------------
    def kv_create(self, kv_type):
        return kv_create_fn(kv_type)

    def kv_init(self, kv, keys, vals):
        for k, v in zip(keys, vals):
            kv.init(int(k), v.data)

    def kv_push(self, kv, keys, vals, priority):
        # the reference C API groups repeated keys within one push call
        # (GroupKVPairs, kvstore_local.h): push([k,k],[a,b]) merges a+b.
        # The Python-level store takes one value (or an explicit list) per
        # key, so regroup here at the C boundary.
        groups, order = {}, []
        for k, v in zip([int(k) for k in keys], vals):
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(v.data)
        kv.push(order,
                [g[0] if len(g) == 1 else g
                 for g in (groups[k] for k in order)],
                priority=int(priority))

    def kv_pull(self, kv, keys, outs, priority):
        for k, out in zip(keys, outs):
            held = torch.empty_like(out.data)
            kv.pull(int(k), held, priority=int(priority))
            out._set_data(held)

    def kv_set_updater(self, kv, py_updater):
        """``py_updater(key, recv, local)`` is the C layer's trampoline to
        the caller's function, which reads and writes NDArray handles; the
        port's store hands its updater tensors and keeps the stored one, so
        the local array's new value is copied back into it."""
        def updater(key, merged, stored):
            local = NDArray(stored)
            py_updater(int(key), NDArray(merged), local)
            if local.data is not stored:
                stored.copy_(local.data)

        kv.set_updater(updater)

    def kv_get_type(self, kv):
        return kv.type

    def kv_get_rank(self, kv):
        return int(kv.rank)

    def kv_get_group_size(self, kv):
        return int(kv.num_workers)

    def kv_barrier(self, kv):
        kv.barrier()

    def kv_send_command(self, kv, head, body):
        kv.send_command_to_servers(int(head), body)

    def kv_is_worker_node(self):
        return int(os.environ.get("DMLC_ROLE", "worker") == "worker")

    def kv_is_server_node(self):
        return int(os.environ.get("DMLC_ROLE", "worker") == "server")

    def kv_is_scheduler_node(self):
        return int(os.environ.get("DMLC_ROLE", "worker") == "scheduler")

    def kv_run_server(self, kv, controller):
        # the in-process group server handles the server role itself
        # (kvstore_server.py); nothing to pump here
        return None

    # -- recordio ------------------------------------------------------------
    def recordio_writer_create(self, uri):
        return rio.MXRecordIO(uri, "w")

    def recordio_reader_create(self, uri):
        return rio.MXRecordIO(uri, "r")

    def recordio_close(self, rec):
        rec.close()

    def recordio_write(self, rec, buf):
        rec.write(bytes(buf))

    def recordio_read(self, rec):
        data = rec.read()
        return data if data is not None else b""

    # -- misc ----------------------------------------------------------------
    def random_seed(self, seed):
        random_mod.seed(int(seed))

    def notify_shutdown(self):
        """Nothing: the embedded interpreter is not finalized (its threads
        and the card's context go down with the process)."""
        return None
