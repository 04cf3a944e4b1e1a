"""Shared base utilities: error type, env-var helpers and a generic registry.

Counterpart of ``mxnet_tpu/base.py``. The port keeps its own copy so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "MXNetTPUError", "ENV_ON_VALUES", "ENV_OFF_VALUES",
           "env_int", "env_bool", "env_str", "Registry", "dtype_code",
           "dtype_from_code", "set_matmul_precision",
           "get_matmul_precision"]


class MXNetError(Exception):
    """Framework error type (name kept for reference-API parity)."""


# the JAX package's alias
MXNetTPUError = MXNetError


ENV_ON_VALUES = ("1", "on", "true", "yes")
ENV_OFF_VALUES = ("0", "off", "false", "no", "none")


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def env_bool(name: str, default: bool) -> bool:
    """``name`` as a switch: ``default`` when unset or empty, else False
    for 0/false/off/no (any case) and True for anything else."""
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() not in ("0", "false", "off", "no")


def env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


class Registry:
    """A named registry of factories (counterpart of dmlc::Registry).

    >>> OPS = Registry('operator')
    >>> @OPS.register('relu')
    ... class Relu: ...
    >>> OPS.create('relu')
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, type] = {}

    def register(self, name=None):
        def _reg(obj):
            key = (name or obj.__name__).lower()
            if key in self._entries and self._entries[key] is not obj:
                raise MXNetError(f"duplicate {self.kind} registration: {key}")
            self._entries[key] = obj
            obj.registry_name = key
            return obj

        return _reg

    def get(self, name: str):
        key = name.lower()
        if key not in self._entries:
            raise MXNetError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._entries)}"
            )
        return self._entries[key]

    def create(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def names(self):
        """The registered names, sorted."""
        return sorted(self._entries)


# the save/load format's dtype codes, the JAX package's (mxnet_tpu/base.py:98-129)
DTYPE_CODES = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bool: 7,
    torch.bfloat16: 8,
}
_CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}


def dtype_code(dt) -> int:
    """The file format's code of a dtype: a torch dtype, or anything
    ``numpy.dtype`` takes (``"bfloat16"`` too)."""
    if not isinstance(dt, torch.dtype):
        name = dt if isinstance(dt, str) else np.dtype(dt).name
        dt = getattr(torch, str(name), None)
    if dt not in DTYPE_CODES:
        raise MXNetError(f"unsupported dtype {dt}")
    return DTYPE_CODES[dt]


def dtype_from_code(code: int) -> torch.dtype:
    """The torch dtype of a file format code (the JAX package returns the
    numpy dtype of the same name)."""
    if code not in _CODE_DTYPES:
        raise MXNetError(f"unknown dtype code {code}")
    return _CODE_DTYPES[code]


# jax_default_matmul_precision's values, by whether f32 contractions may
# round their operands to TF32 on the tensor cores
_PRECISIONS = {"highest": False, "float32": False,
               "default": True, "high": True, "tensorfloat32": True}
_PRECISION = ["default"]


def set_matmul_precision(precision: str):
    """The precision of f32 GEMMs and convolutions, the counterpart of
    ``jax_default_matmul_precision``: ``"highest"`` / ``"float32"`` keep
    f32 (TF32 off for both ``torch.backends.cuda.matmul`` and ``cudnn``);
    ``"default"`` / ``"high"`` / ``"tensorfloat32"`` let the card round the
    operands to TF32 (both on). Any other value raises. The package sets
    ``"default"`` at import, as the JAX package leaves the backend's fast
    path; parity checks pin ``"highest"``. It moves process-wide flags, so
    it holds for every f32 contraction after the call."""
    key = str(precision).lower()
    if key not in _PRECISIONS:
        raise ValueError(
            f"unknown matmul precision {precision!r}; expected one of "
            f"{sorted(_PRECISIONS)}")
    torch.backends.cuda.matmul.allow_tf32 = _PRECISIONS[key]
    torch.backends.cudnn.allow_tf32 = _PRECISIONS[key]
    _PRECISION[0] = key


def get_matmul_precision() -> str:
    """The value of the last :func:`set_matmul_precision`."""
    return _PRECISION[0]


set_matmul_precision(_PRECISION[0])
