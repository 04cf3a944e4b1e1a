"""The imperative NDArray, its functions, and the ``.params`` container.

Counterpart of ``mxnet_tpu/ndarray.py``. An :class:`NDArray` wraps a torch
tensor on its context's device and keeps the JAX package's contract: a
write (``+=``, ``a[i:j] = x``, ``copyto``, ``out=``) rebinds the wrapper to
a new tensor, as the JAX package rebinds its immutable ``jax.Array``, so a
tensor that autograd saved, or that another array still reads, is never
written in place. Reads (slices, ``reshape``, ``T``) may be views, which is
safe for the same reason. Work is queued on the device's current stream;
``wait_to_read`` synchronizes that stream and ``asnumpy`` is a sync point.
The default context is :func:`current_context`, ``gpu(0)`` outside a
``with mt.cpu():`` block, where the JAX package's is ``cpu()``. ``dtype``
is a numpy dtype, or ``torch.bfloat16``; ``asnumpy`` of a bfloat16 array
is float32, which holds it exactly (numpy has no bfloat16).

The ``.params`` container (``save``/``load``, magic numbers ``0x112`` for a
list and ``0x1121`` for a name->array dict, then one header of dtype code,
rank and int64 shape per array and its raw little-endian bytes, then the
names) has the JAX package's layout and dtype codes, so a file written by
either package loads in the other. Values are NDArrays, torch tensors or
numpy arrays on save; loading returns CPU tensors.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .base import DTYPE_CODES, MXNetError
from .context import Context, current_context, place

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "save", "load", "waitall", "concatenate", "dot", "onehot_encode",
           "choose_element_0index", "clip", "square", "sqrt", "exp", "log",
           "norm", "maximum", "minimum", "abs", "sum", "max", "min",
           "argmax_channel", "random_uniform", "random_gaussian"]

real_t = np.float32


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _ctx_of(t: torch.Tensor) -> Context:
    if t.is_cuda:
        return Context("gpu", t.device.index)
    return Context("cpu", 0)


# the live-array ledger (telemetry.memory.track_arrays installs it): every
# NDArray made while it is set is accounted by bytes, weakly referenced
_LEDGER = None


class NDArray:
    """A tensor on a context, with the JAX package's NDArray surface."""

    __slots__ = ("_data", "_ctx", "writable", "__weakref__")

    def __init__(self, data, ctx: Context | None = None, writable=True):
        if isinstance(data, NDArray):
            ctx = ctx or data._ctx
            data = data._data
        if not isinstance(data, torch.Tensor):
            arr = np.asarray(data)
            if not hasattr(data, "dtype"):
                arr = arr.astype(real_t)
            data = torch.from_numpy(np.ascontiguousarray(arr))
        if ctx is not None:
            data = place(data, ctx)
        self._data = data
        self._ctx = ctx if ctx is not None else _ctx_of(data)
        self.writable = writable
        if _LEDGER is not None:
            _LEDGER.add(self)

    # -- properties -----------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The tensor holding the current value."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return torch.empty(0, dtype=self._data.dtype).numpy().dtype

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    # -- sync points ----------------------------------------------------------
    def wait_to_read(self):
        """Return once the value is computed: synchronizes the stream of
        the array's device."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy as numpy (bfloat16 as float32); waits for the value."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("asscalar requires size-1 NDArray")
        return self.asnumpy().reshape(())[()]

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    # -- writes: rebind, never in place ----------------------------------------
    def _set_data(self, new: torch.Tensor):
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if tuple(new.shape) != self.shape:
            raise MXNetError(f"shape mismatch writing {tuple(new.shape)} "
                             f"into {self.shape}")
        self._data = place(new.to(self._data.dtype), self._ctx)
        return self

    def _operand(self, value):
        if isinstance(value, NDArray):
            return value._data
        if isinstance(value, (np.ndarray, list, tuple)):
            return torch.as_tensor(np.asarray(value),
                                   device=self._data.device)
        return value

    def __setitem__(self, key, value):
        value = self._operand(value)
        if key == slice(None) or key is Ellipsis:
            if isinstance(value, torch.Tensor):
                new = value.to(self._data.dtype).to(self._data.device)
                new = new.expand(self.shape).clone()
            else:
                new = torch.full(self.shape, value, dtype=self._data.dtype,
                                 device=self._data.device)
        else:
            new = self._data.clone()
            new[key] = value
        self._set_data(new)

    def __getitem__(self, key):
        return NDArray(self._data[key], self._ctx)

    def slice(self, start, stop):
        """Rows ``start:stop`` (axis 0)."""
        return NDArray(self._data[start:stop], self._ctx)

    def reshape(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(shape), self._ctx)

    @property
    def T(self):
        return NDArray(self._data.permute(*reversed(range(self.ndim))),
                       self._ctx)

    def astype(self, dtype):
        return NDArray(self._data.to(_torch_dtype(dtype)), self._ctx)

    # -- placement ------------------------------------------------------------
    def copyto(self, other):
        """Copy into another NDArray (rebinding it, in its dtype) or to a
        new array on a Context."""
        if isinstance(other, Context):
            return NDArray(self._data.clone(), other) \
                if other == self._ctx else NDArray(self._data, other)
        if not isinstance(other, NDArray):
            raise TypeError("copyto target must be NDArray or Context")
        return other._set_data(self._data)

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def as_in_context(self, ctx: Context):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    # -- arithmetic -----------------------------------------------------------
    def _binary(self, other, fn):
        return NDArray(fn(self._data, self._operand(other)), self._ctx)

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, torch.true_divide)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a)

    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binary(other, torch.pow)

    def __neg__(self):
        return NDArray(-self._data, self._ctx)

    def __iadd__(self, other):
        return self._set_data(self._data + self._operand(other))

    def __isub__(self, other):
        return self._set_data(self._data - self._operand(other))

    def __imul__(self, other):
        return self._set_data(self._data * self._operand(other))

    def __itruediv__(self, other):
        return self._set_data(self._data / self._operand(other))

    def __eq__(self, other):  # identity, like the reference's handles
        return self is other

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"<NDArray {self.shape} @{self._ctx}>"

    def __reduce__(self):
        return (_unpickle, (self._data.detach().cpu(),
                            self._ctx.device_type, self._ctx.device_id,
                            self.writable))


def _unpickle(data, device_type, device_id, writable):
    return NDArray(data, Context(device_type, device_id), writable)


# -- creation -----------------------------------------------------------------
def _resolve_ctx(ctx):
    return ctx if ctx is not None else current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=real_t) -> NDArray:
    """An NDArray holding ``source_array`` (anything numpy takes)."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    dt = _torch_dtype(dtype)
    if dt == torch.bfloat16:
        t = torch.from_numpy(np.asarray(source_array, np.float32)).to(dt)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(source_array, dtype=dtype)))
    return NDArray(t, _resolve_ctx(ctx))


def _filled(shape, value, ctx, dtype):
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.full(_shape(shape), value, dtype=_torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


def empty(shape, ctx=None, dtype=real_t) -> NDArray:
    """An array of ``shape``; zeros, as in the JAX package."""
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=real_t) -> NDArray:
    return _filled(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype=real_t) -> NDArray:
    return _filled(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype=real_t) -> NDArray:
    return _filled(shape, val, ctx, dtype)


def arange(start, stop=None, step=1.0, ctx=None, dtype=real_t) -> NDArray:
    """``np.arange(start, stop, step, dtype)``, as ``jnp.arange`` computes
    it for concrete bounds."""
    return array(np.arange(start, stop, step, dtype=dtype), ctx, dtype)


def waitall():
    """Return once every card's queued work is done."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# -- functions ----------------------------------------------------------------
def _out_wrap(result: torch.Tensor, out, ctx) -> NDArray:
    if out is None:
        return NDArray(result, ctx)
    return out._set_data(result)


def _value(x):
    return x._data if isinstance(x, NDArray) else x


def _ctx_from(*xs):
    return next(x._ctx for x in xs if isinstance(x, NDArray))


def _fn2(fn, name):
    def wrapped(lhs, rhs, out=None):
        return _out_wrap(fn(_value(lhs), _value(rhs)), out, _ctx_from(lhs, rhs))

    wrapped.__name__ = wrapped.__qualname__ = name
    return wrapped


def _fn1(fn, name, doc=None):
    def wrapped(src, out=None):
        return _out_wrap(fn(_value(src)), out, _ctx_from(src))

    wrapped.__name__ = wrapped.__qualname__ = name
    wrapped.__doc__ = doc
    return wrapped


_plus = _fn2(torch.add, "_plus")
_minus = _fn2(torch.sub, "_minus")
_mul = _fn2(torch.mul, "_mul")
_div = _fn2(torch.true_divide, "_div")
_plus_scalar = _fn2(torch.add, "_plus_scalar")
_minus_scalar = _fn2(torch.sub, "_minus_scalar")
_mul_scalar = _fn2(torch.mul, "_mul_scalar")
_div_scalar = _fn2(torch.true_divide, "_div_scalar")
_rminus_scalar = _fn2(lambda a, b: b - a, "_rminus_scalar")
_rdiv_scalar = _fn2(lambda a, b: b / a, "_rdiv_scalar")
dot = _fn2(torch.matmul, "dot")
maximum = _fn2(torch.maximum, "maximum")
minimum = _fn2(torch.minimum, "minimum")
square = _fn1(torch.square, "square")
sqrt = _fn1(torch.sqrt, "sqrt")
exp = _fn1(torch.exp, "exp")
log = _fn1(torch.log, "log")
abs = _fn1(torch.abs, "abs")  # noqa: A001 - the reference's name
norm = _fn1(lambda a: torch.sqrt(torch.sum(torch.square(a.float()))).reshape(1),
            "norm", "L2 norm in f32 as a length-1 array.")
sum = _fn1(lambda a: torch.sum(a).reshape(1), "sum")  # noqa: A001
max = _fn1(lambda a: torch.amax(a).reshape(1), "max")  # noqa: A001
min = _fn1(lambda a: torch.amin(a).reshape(1), "min")  # noqa: A001
argmax_channel = _fn1(lambda a: torch.argmax(a, dim=1).to(a.dtype),
                      "argmax_channel", "Row-wise argmax of a 2-D array, in "
                      "the array's dtype.")


def onehot_encode(indices, out, **_ignored):
    """Fill ``out`` (batch, depth) with the one-hot rows of ``indices``
    (batch,); ``out`` is written (rebound) and returned."""
    o = out._data
    idx = _value(indices).to(torch.int32).long()
    hot = torch.zeros(o.shape, dtype=o.dtype, device=o.device)
    hot.scatter_(1, idx.to(o.device)[:, None], 1)
    return out._set_data(hot)


def choose_element_0index(lhs, rhs, out=None):
    """``out[i] = lhs[i, rhs[i]]``."""
    a = _value(lhs)
    idx = _value(rhs).to(torch.int32).long()
    return _out_wrap(torch.gather(a, 1, idx[:, None])[:, 0], out,
                     _ctx_from(lhs, rhs))


def clip(src, a_min, a_max, out=None):
    return _out_wrap(torch.clamp(_value(src), a_min, a_max), out,
                     _ctx_from(src))


def _copyto(src, out=None):
    """The registered ``_copyto``: ``src`` copied into ``out``."""
    if out is None:
        raise MXNetError("_copyto requires out=")
    return src.copyto(out)


def concatenate(arrays, axis=0):
    return NDArray(torch.cat([a._data for a in arrays], dim=axis),
                   arrays[0]._ctx)


def random_uniform(low=0.0, high=1.0, shape=None, out=None):
    """Uniform samples in [low, high) (``random.uniform``)."""
    from . import random as _random

    return _random.uniform(low, high, shape, out=out)


def random_gaussian(loc=0.0, scale=1.0, shape=None, out=None):
    """Gaussian samples (``random.normal``)."""
    from . import random as _random

    return _random.normal(loc, scale, shape, out=out)


# -- the .params container ------------------------------------------------------
_NDAR_MAGIC = 0x112
_NAMED_MAGIC = 0x1121

# the JAX package's dtype codes (mxnet_tpu/base.py:98-129)
_CODES = DTYPE_CODES
_DTYPES = {v: k for k, v in _CODES.items()}


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    return torch.from_numpy(np.ascontiguousarray(value))


def _raw_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: write its bits
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _write_one(f, value):
    t = _as_tensor(value)
    if t.dtype not in _CODES:
        raise MXNetError(f"unsupported dtype {t.dtype}")
    f.write(struct.pack("<II", _CODES[t.dtype], t.dim()))
    f.write(struct.pack(f"<{t.dim()}q", *t.shape))
    f.write(_raw_bytes(t))


def _read_one(f) -> torch.Tensor:
    code, ndim = struct.unpack("<II", f.read(8))
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
    if code not in _DTYPES:
        raise MXNetError(f"unknown dtype code {code}")
    dtype = _DTYPES[code]
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    buf = bytearray(f.read(nbytes))
    if len(buf) != nbytes:
        raise ValueError(f"truncated array: {len(buf)} of {nbytes} bytes")
    flat = torch.frombuffer(buf, dtype=dtype) if n else torch.empty(0, dtype=dtype)
    return flat.reshape(shape)


def save(fname: str, data):
    """Save a list of arrays or a str->array dict (reference: mx.nd.save)."""
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
        magic = _NAMED_MAGIC
    elif isinstance(data, (list, tuple)):
        names, arrays = None, list(data)
        magic = _NDAR_MAGIC
    else:
        raise MXNetError("save expects a dict or a list of arrays")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", magic, len(arrays)))
        for a in arrays:
            _write_one(f, a)
        if names is not None:
            for name in names:
                b = name.encode("utf-8")
                f.write(struct.pack("<I", len(b)))
                f.write(b)


def load(fname: str):
    """Load what :func:`save` (of either package) wrote: a list or a dict of
    CPU tensors."""
    try:
        with open(fname, "rb") as f:
            magic, count = struct.unpack("<QQ", f.read(16))
            if magic not in (_NDAR_MAGIC, _NAMED_MAGIC):
                raise MXNetError(f"invalid NDArray file {fname!r}")
            arrays = [_read_one(f) for _ in range(count)]
            if magic == _NDAR_MAGIC:
                return arrays
            names = []
            for _ in range(count):
                (ln,) = struct.unpack("<I", f.read(4))
                names.append(f.read(ln).decode("utf-8"))
            return dict(zip(names, arrays))
    except (struct.error, ValueError) as e:
        raise MXNetError(f"corrupt NDArray file {fname!r}: {e}") from None
