"""The native data pipeline: a ctypes loader of ``mxtpu_native.cc``.

Counterpart of ``mxnet_tpu/native/__init__.py``. RecordIO scanning, JPEG
decoding, augmentation and batch assembly run in C++ threads
(``mxtpu_native.cc``, the JAX package's pipeline with a JPEG codec of its
own in place of libjpeg, which the card's machine lacks: it decodes
baseline, progressive and arithmetic-coded files and encodes baseline
ones); Python only hands over buffers.

The library is built with the host's C++ compiler (``CXX``, else ``g++``)
at its first use, never at import, into ``build/mxnet_tpu_torch/`` at the
repository root, named by a hash of the source and flags, as the CUDA
kernels are. Its flags are the JAX package's Makefile's (no
``-march=native``, no ``-ffast-math``), so the float normalisation rounds
as the reference's. :func:`get_lib` returns None when the library cannot be
built or loaded, and every consumer then takes its Python path;
:func:`require_lib` raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..base import MXNetError
from ..kernels._common import BUILD_DIR

__all__ = ["get_lib", "require_lib", "scan_offsets", "NativePipeline",
           "decode_jpeg", "encode_jpeg"]

SOURCE = Path(__file__).resolve().with_name("mxtpu_native.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LDLIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_error = None  # why the library is unavailable, once a build failed


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LDLIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmxtpu_native-{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise MXNetError("no C++ compiler (set CXX); the native pipeline is "
                         "built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        *LDLIBS], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise MXNetError(f"{cxx} failed for {SOURCE.name} (exit "
                         f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return out


def _bind(lib):
    c_int, c_int64, c_float, vp = (ctypes.c_int, ctypes.c_int64,
                                   ctypes.c_float, ctypes.c_void_p)
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    lib.mxtpu_scan_offsets.restype = c_int64
    lib.mxtpu_scan_offsets.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_int64), c_int64]
    lib.mxtpu_pipeline_create.restype = vp
    lib.mxtpu_pipeline_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_int64), c_int64,
        c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
        ctypes.POINTER(c_float), c_float, c_int, ctypes.c_uint32, c_int,
        c_int, c_int, c_int, c_int, ctypes.POINTER(c_float), c_int]
    lib.mxtpu_pipeline_next.restype = c_int
    lib.mxtpu_pipeline_next.argtypes = [vp, vp, vp, ctypes.POINTER(c_int)]
    lib.mxtpu_pipeline_reset.restype = None
    lib.mxtpu_pipeline_reset.argtypes = [vp]
    lib.mxtpu_pipeline_batches.restype = c_int64
    lib.mxtpu_pipeline_batches.argtypes = [vp]
    lib.mxtpu_pipeline_destroy.restype = None
    lib.mxtpu_pipeline_destroy.argtypes = [vp]
    lib.mxtpu_jpeg_decode.restype = c_int
    lib.mxtpu_jpeg_decode.argtypes = [
        ctypes.c_char_p, c_int64, u8pp, ctypes.POINTER(c_int),
        ctypes.POINTER(c_int)]
    lib.mxtpu_jpeg_encode.restype = c_int64
    lib.mxtpu_jpeg_encode.argtypes = [vp, c_int, c_int, c_int, c_int, u8pp]
    lib.mxtpu_free.restype = None
    lib.mxtpu_free.argtypes = [vp]
    return lib


def require_lib():
    """The loaded library, built now if needed; raises ``MXNetError`` (with
    the compiler's output) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise MXNetError(_error)
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (MXNetError, OSError, subprocess.SubprocessError) as e:
                _error = f"native library unavailable: {e}"
                raise MXNetError(_error) from e
        return _lib


def get_lib():
    """The loaded library, or None when it cannot be built or loaded."""
    try:
        return require_lib()
    except MXNetError:
        return None


def scan_offsets(path: str):
    """Record offsets of a RecordIO file by the native header scan, or None
    when the library is unavailable or the file is not RecordIO."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 1 << 16
    while True:
        buf = (ctypes.c_int64 * cap)()
        n = lib.mxtpu_scan_offsets(os.fsencode(path), buf, cap)
        if n < 0:
            return None
        if n <= cap:
            return list(buf[:n])
        cap = n


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes as an HWC uint8 RGB array, the pixels libjpeg gives with
    its defaults (what PIL's ``convert("RGB")`` gives); raises
    ``MXNetError`` for a file the codec does not take (lossless,
    hierarchical, 12-bit, CMYK, truncated or corrupt; baseline and
    progressive files decode, Huffman or arithmetic coded)."""
    lib = require_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.mxtpu_jpeg_decode(bytes(buf), len(buf), ctypes.byref(out),
                             ctypes.byref(h), ctypes.byref(w)) != 0:
        raise MXNetError("JPEG the native codec does not take (lossless, "
                         "hierarchical, 12-bit, CMYK, truncated or "
                         "corrupt)")
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.mxtpu_free(out)


def encode_jpeg(img, quality: int = 95) -> bytes:
    """An HW or HWC (3 channels) uint8 image as baseline JPEG bytes, as
    libjpeg writes them under ``jpeg_set_defaults`` and
    ``jpeg_set_quality(quality, TRUE)`` (PIL's ``save(format="JPEG",
    quality=quality)``): 4:2:0 for colour, the standard Huffman tables."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or channels not in (1, 3):
        raise MXNetError(f"encode_jpeg: an HW or HWC image of 1 or 3 "
                         f"channels, got shape {img.shape}")
    lib = require_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.mxtpu_jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1],
                              channels, int(quality), ctypes.byref(out))
    if n < 0:
        raise MXNetError(f"encode_jpeg: cannot encode an image of shape "
                         f"{img.shape}")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.mxtpu_free(out)


class NativePipeline:
    """The C++ pipeline over one RecordIO file's records at ``offsets``:
    the JAX package's ``NativePipeline`` with the same arguments, whose
    batches it equals bit for bit. :meth:`next` writes each batch into new
    tensors, pinned where a card is present, so that the trainer's device
    feed copies them to the card without another host copy.
    ``num_threads`` defaults to one less than the host's cores, as the
    reference's."""

    def __init__(self, path, offsets, batch, data_shape, label_width=1,
                 rand_crop=False, rand_mirror=False, resize=-1, mean=None,
                 scale=1.0, shuffle=False, seed=0, num_threads=None,
                 prefetch=4, round_batch=True, nhwc=False, out_u8=False,
                 min_random_scale=1.0, max_random_scale=1.0,
                 min_img_size=0.0, max_img_size=0.0,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 mirror=False):
        if out_u8 and (mean is not None or scale != 1.0
                       or max_random_contrast or max_random_illumination):
            raise ValueError("uint8 output emits raw pixels: mean/scale and "
                             "contrast/illumination must be left for the "
                             "device side")
        lib = require_lib()
        self._lib = lib
        self._handle = None
        self.batch = int(batch)
        self.data_shape = tuple(data_shape)
        self.label_width = int(label_width)
        self.nhwc, self.out_u8 = bool(nhwc), bool(out_u8)
        self.pin_memory = torch.cuda.is_available()
        self.num_threads = int(num_threads or max(1, (os.cpu_count() or 2) - 1))
        off = (ctypes.c_int64 * len(offsets))(*offsets)
        mean_ptr = None
        if mean is not None:
            mean_ptr = (ctypes.c_float * 3)(*[float(m) for m in mean])
        aug = (min_random_scale, max_random_scale, min_img_size,
               max_img_size, max_random_contrast, max_random_illumination)
        aug_ptr = None
        if aug != (1.0, 1.0, 0.0, 0.0, 0.0, 0.0):
            aug_ptr = (ctypes.c_float * 6)(*[float(a) for a in aug])
        c, h, w = self.data_shape
        self._handle = lib.mxtpu_pipeline_create(
            os.fsencode(path), off, len(offsets), self.batch, c, h, w,
            self.label_width, int(rand_crop), int(rand_mirror), int(resize),
            mean_ptr, float(scale), int(shuffle), int(seed) & 0xFFFFFFFF,
            self.num_threads, int(prefetch), int(round_batch),
            int(self.nhwc), int(self.out_u8), aug_ptr, int(mirror))
        if not self._handle:
            raise MXNetError(f"failed to open native pipeline on {path!r}")

    def next(self):
        """``(data, labels, pad)``: data ``[B, C, H, W]`` (or ``[B, H, W,
        C]`` under ``nhwc``), float32, or raw uint8 under ``out_u8``;
        labels float32; raises StopIteration at the epoch's end."""
        c, h, w = self.data_shape
        shape = (self.batch,) + ((h, w, c) if self.nhwc else (c, h, w))
        dtype = torch.uint8 if self.out_u8 else torch.float32
        data = torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)
        labels = torch.empty((self.batch,) if self.label_width == 1
                             else (self.batch, self.label_width),
                             dtype=torch.float32, pin_memory=self.pin_memory)
        pad = ctypes.c_int(0)
        rc = self._lib.mxtpu_pipeline_next(self._handle, data.data_ptr(),
                                           labels.data_ptr(),
                                           ctypes.byref(pad))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise MXNetError("native pipeline failed (a bad record, or an "
                             "image the JPEG codec does not take)")
        return data, labels, pad.value

    def reset(self):
        self._lib.mxtpu_pipeline_reset(self._handle)

    @property
    def batches_per_epoch(self):
        return self._lib.mxtpu_pipeline_batches(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mxtpu_pipeline_destroy(self._handle)
            self._handle = None
