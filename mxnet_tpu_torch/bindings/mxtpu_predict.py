# coding: utf-8
"""Lightweight standalone prediction API.

Counterpart of the JAX package's ``predict/python/mxtpu_predict.py``
(reference capability: predict/python/mxnet_predict.py, a ctypes-only
Predictor for deployment hosts that must not install the full package).

This file depends on nothing of either package: it speaks the C predict
ABI of the native predictor library directly (the dependency-free C++
predictor over exported ``.mxtpu`` bundles: no Python framework on the
serving path). Build the library with ``python -c "from
mxnet_tpu_torch.native.predict import get_predict_lib; get_predict_lib()"``
(it lands in ``build/mxnet_tpu_torch/`` as ``libmxtpu_predict-<hash>.so``),
or take the amalgamated build. Copy this one file plus the .so next to your
bundle and serve.

    from mxtpu_predict import Predictor
    p = Predictor("model.mxtpu")
    probs = p.predict({"data": batch})[0]
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

__all__ = ["Predictor", "find_lib_path"]


def find_lib_path():
    """Candidate predict libraries that exist: ``libmxtpu_predict.so``
    beside this file or in the working directory, then the port's build
    directory's ``libmxtpu_predict-*.so``, newest first (reference:
    _find_lib_path's candidate-list discipline)."""
    here = os.path.dirname(os.path.abspath(os.path.expanduser(__file__)))
    build = os.path.join(here, "..", "..", "build", "mxnet_tpu_torch")
    candidates = [os.path.join(here, "libmxtpu_predict.so"),
                  os.path.join(os.getcwd(), "libmxtpu_predict.so")]
    built = sorted(glob.glob(os.path.join(build, "libmxtpu_predict-*.so")),
                   key=os.path.getmtime, reverse=True)
    paths = [p for p in candidates if os.path.isfile(p)] + built
    if not paths:
        raise RuntimeError(
            "Cannot find libmxtpu_predict.so.\nList of candidates:\n"
            + "\n".join(candidates + [os.path.join(
                build, "libmxtpu_predict-*.so")])
            + "\nBuild it with: python -c \"from mxnet_tpu_torch.native."
            "predict import get_predict_lib; get_predict_lib()\"")
    return paths


def _load_lib():
    lib = ctypes.CDLL(find_lib_path()[0])
    lib.mxtpu_pred_create.restype = ctypes.c_void_p
    lib.mxtpu_pred_create.argtypes = [ctypes.c_char_p]
    lib.mxtpu_pred_last_error.restype = ctypes.c_char_p
    lib.mxtpu_pred_set_input.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int]
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
    return lib


_LIB = None


class Predictor:
    """Forward-only predictor over an exported ``.mxtpu`` bundle
    (``Predictor.export`` of either package writes them; reference analog:
    Predictor over MXPredCreate in predict/python/mxnet_predict.py)."""

    def __init__(self, bundle_path):
        global _LIB
        if _LIB is None:
            _LIB = _load_lib()
        self._lib = _LIB
        self._h = self._lib.mxtpu_pred_create(
            str(bundle_path).encode("utf-8"))
        if not self._h:
            raise RuntimeError(
                "load failed: "
                + self._lib.mxtpu_pred_last_error().decode())

    def _check(self, rc):
        if rc < 0:
            raise RuntimeError(self._lib.mxtpu_pred_last_error().decode())
        return rc

    def forward(self, **inputs):
        """Set named inputs (numpy arrays) and run one forward pass."""
        for name, arr in inputs.items():
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            self._check(self._lib.mxtpu_pred_set_input(
                self._h, name.encode("utf-8"),
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                shape, arr.ndim))
        self._check(self._lib.mxtpu_pred_forward(self._h))

    def get_output(self, index):
        ndim = self._check(self._lib.mxtpu_pred_output_ndim(self._h, index))
        shape = (ctypes.c_int64 * max(1, ndim))()
        self._check(self._lib.mxtpu_pred_output_shape(self._h, index, shape))
        out_shape = tuple(shape[i] for i in range(ndim))
        n = int(np.prod(out_shape)) if out_shape else 1
        buf = np.empty(n, np.float32)
        got = self._check(self._lib.mxtpu_pred_get_output(
            self._h, index,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(n)))
        return buf[:got].reshape(out_shape)

    def predict(self, inputs):
        """One-call convenience: dict of inputs -> list of output arrays."""
        self.forward(**inputs)
        n = self._lib.mxtpu_pred_num_outputs(self._h)
        return [self.get_output(i) for i in range(n)]

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None) is not None:
            self._lib.mxtpu_pred_free(h)
