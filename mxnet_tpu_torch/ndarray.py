"""The ``.params`` container: save and load named tensors.

Counterpart of the serialisation part of ``mxnet_tpu/ndarray.py``
(``save``/``load``, magic numbers ``0x112`` for a list and ``0x1121`` for a
name->array dict, then one header of dtype code, rank and int64 shape per
array and its raw little-endian bytes, then the names). The layout and
dtype codes are the JAX package's, so a file written by either package loads
in the other. Values are torch tensors (numpy arrays are accepted on save);
loading returns CPU tensors.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .base import MXNetError

__all__ = ["save", "load"]

_NDAR_MAGIC = 0x112
_NAMED_MAGIC = 0x1121

# the JAX package's dtype codes (mxnet_tpu/base.py:98-129)
_CODES = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bool: 7,
    torch.bfloat16: 8,
}
_DTYPES = {v: k for k, v in _CODES.items()}


def _as_tensor(value) -> torch.Tensor:
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
