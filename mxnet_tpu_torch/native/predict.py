"""ctypes wrapper over the native C++ predictor (``mxtpu_predict.cc``).

Counterpart of the JAX package's ``native/predict.py`` (reference: the C
predict API, include/mxnet/c_predict_api.h, handle-based
MXPredCreate/MXPredSetInput/MXPredForward/MXPredGetOutput, as shipped by
the amalgamation build: a deployment path with no Python framework). The
artifact is the ``.mxtpu`` bundle that :meth:`Predictor.export` of either
package writes; the C++ runtime parses it (zip + symbol JSON + npy params)
and runs the graph with plain CPU kernels, needing only zlib and pthreads.

The predictor is a CPU runtime and has no card path, as the JAX package's
has no TPU path. Its library is built at first use with the host's C++
compiler into ``build/mxnet_tpu_torch/libmxtpu_predict-<hash>.so`` (a hash
of the source and flags, the JAX Makefile's flags), never at import;
:func:`get_predict_lib` returns None when it cannot be built or loaded, and
:class:`NativePredictor` then raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..analysis.lockwatch import named_lock
from ..base import MXNetError
from ..kernels._common import BUILD_DIR
from . import compile_cxx

__all__ = ["NativePredictor", "get_predict_lib", "load_lib"]

SOURCE = Path(__file__).resolve().with_name("mxtpu_predict.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LDLIBS = ("-lz",)

_lock = named_lock("native.predict.loader")
_lib = None
_error = None  # why the library is unavailable, once a build failed


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LDLIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmxtpu_predict-{digest}.so"


def load_lib(path):
    """Load and configure a predict library from an explicit .so path
    (the amalgamated build's, for one)."""
    lib = ctypes.CDLL(os.fspath(path))
    _configure(lib)
    return lib


def get_predict_lib():
    """The loaded native predict library, built now if needed, or None when
    it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = load_lib(compile_cxx(SOURCE, library_path(),
                                            CXX_FLAGS, LDLIBS))
            except (MXNetError, OSError, subprocess.SubprocessError) as e:
                _error = f"native predict library unavailable: {e}"
        return _lib


def _configure(lib):
    lib.mxtpu_pred_create.restype = ctypes.c_void_p
    lib.mxtpu_pred_create.argtypes = [ctypes.c_char_p]
    lib.mxtpu_pred_last_error.restype = ctypes.c_char_p
    lib.mxtpu_pred_set_input.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.mxtpu_pred_forward.argtypes = [ctypes.c_void_p]
    lib.mxtpu_pred_num_outputs.argtypes = [ctypes.c_void_p]
    lib.mxtpu_pred_output_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mxtpu_pred_output_shape.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    lib.mxtpu_pred_get_output.restype = ctypes.c_int64
    lib.mxtpu_pred_get_output.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.mxtpu_pred_free.argtypes = [ctypes.c_void_p]


class NativePredictor:
    """Forward-only model runner on the C++ CPU runtime.

    Usage mirrors the reference predict API::

        pred = NativePredictor("model.mxtpu")
        pred.set_input("data", batch)           # MXPredSetInput
        pred.forward()                          # MXPredForward
        probs = pred.get_output(0)              # MXPredGetOutput
    """

    def __init__(self, bundle_path, lib=None):
        lib = lib if lib is not None else get_predict_lib()
        if lib is None:
            raise RuntimeError(_error or "native predict library unavailable")
        self._lib = lib
        self._handle = lib.mxtpu_pred_create(os.fspath(bundle_path).encode())
        if not self._handle:
            raise RuntimeError(f"failed to load bundle: {self._err()}")

    def _err(self) -> str:
        return self._lib.mxtpu_pred_last_error().decode()

    def set_input(self, name: str, value) -> None:
        arr = np.ascontiguousarray(np.asarray(value), dtype=np.float32)
        shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
        self._lib.mxtpu_pred_set_input(
            self._handle, name.encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            shape, arr.ndim)

    def forward(self, **inputs) -> None:
        for name, value in inputs.items():
            self.set_input(name, value)
        if self._lib.mxtpu_pred_forward(self._handle) != 0:
            raise RuntimeError(f"native forward failed: {self._err()}")

    @property
    def num_outputs(self) -> int:
        return self._lib.mxtpu_pred_num_outputs(self._handle)

    def get_output(self, index: int = 0) -> np.ndarray:
        ndim = self._lib.mxtpu_pred_output_ndim(self._handle, index)
        if ndim < 0:
            raise IndexError(f"output {index} out of range")
        shape = (ctypes.c_int64 * max(ndim, 1))()
        self._lib.mxtpu_pred_output_shape(self._handle, index, shape)
        buf = np.empty(tuple(shape[i] for i in range(ndim)), np.float32)
        n = self._lib.mxtpu_pred_get_output(
            self._handle, index,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size)
        if n < 0:
            raise RuntimeError(f"get_output failed: {self._err()}")
        return buf

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mxtpu_pred_free(self._handle)
            self._handle = None
