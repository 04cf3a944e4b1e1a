"""Data iterators.

Counterpart of ``mxnet_tpu/io/__init__.py``:

- ``NDArrayIter``: in-memory batching with the reference's pad semantics
  (the last partial batch wraps around to the epoch start and reports
  ``pad``, the number of wrapped rows) or ``roll_over``;
- ``MNISTIter``: idx files (``.gz`` too), flat or 4-D, sharded by
  ``num_parts`` / ``part_index``;
- ``CSVIter``: rows of a CSV file;
- ``ImageRecordIter``: RecordIO shards -> decode -> augment -> normalise ->
  batch. JPEG records take the native C++ pipeline (``native``: record
  reads, decode, augmentation and batch assembly in C++ threads) under
  the JAX package's conditions (``MXNET_TPU_NATIVE_IO``, default on; an
  RGB mean; no Python-only augmenter; a local file), and its batches equal
  the JAX package's native pipeline's bit for bit. Otherwise each batch is
  decoded by a task on the host engine (``engine.py``) with its own
  ``RandomState``, seeded on the main thread, and ``prefetch_buffer``
  batches in flight: the JAX package's Python path
  (``io/__init__.py:260-970``), with PIL's calls replaced by the port's
  own copies (``_imaging.py``), the same batches bit for bit;
- ``PrefetchingIter``: runs a wrapped iterator ahead on the host engine.

Batches hold CPU tensors; the trainer moves them to its device.
"""

from __future__ import annotations

import collections
import gzip
import logging
import os
import struct
import time as _time

import numpy as np
import torch

from ..base import MXNetError, env_int
from ..engine import engine
from ..filesystem import is_remote_uri, open_uri
from ..params import REQUIRED, Range, TupleParam, apply_params, autodoc
from . import _imaging

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "ImageRecordIter", "PrefetchingIter", "CSVIter"]


class DataBatch:
    """One batch: data and label tensors and the pad count."""

    def __init__(self, data, label, pad=0, index=None):
        self.data = data if isinstance(data, list) else [data]
        self.label = label if isinstance(label, list) else [label]
        self.pad = pad
        self.index = index

    @property
    def num_valid(self):
        """Leading rows that carry real samples: the rows less ``pad``."""
        rows = int(self.data[0].shape[0]) if self.data else 0
        return rows - int(self.pad or 0)


class DataIter:
    """Base iterator."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        raise NotImplementedError

    def next(self):
        """Return the next DataBatch or raise StopIteration."""
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        return self.next()

    @property
    def provide_data(self):
        """List of (name, shape) for data."""
        raise NotImplementedError

    @property
    def provide_label(self):
        raise NotImplementedError

    def getpad(self):
        return 0


class NDArrayIter(DataIter):
    """Batching over in-memory arrays (numpy arrays or tensors)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__()
        # a private RNG when seeded, so construction leaves numpy's global
        # RNG alone
        self._rng = np.random.RandomState(seed) if seed is not None else np.random
        self.data = self._to_np(data)
        n = self.data.shape[0]
        self.label = self._to_np(label) if label is not None else np.zeros((n,), np.float32)
        if self.label.shape[0] != n:
            raise MXNetError("data/label count mismatch")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.data_name, self.label_name = data_name, label_name
        self.num_data = n
        if n < batch_size:
            raise MXNetError("batch_size larger than dataset")
        self._order = np.arange(n)
        self.cursor = -batch_size
        self.reset()

    @staticmethod
    def _to_np(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if hasattr(x, "asnumpy"):
            return x.asnumpy()
        return np.asarray(x)

    def reset(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch([torch.from_numpy(self._take(self.data))],
                         [torch.from_numpy(self._take(self.label))],
                         pad=self.getpad())

    def _take(self, arr):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            idx = self._order[self.cursor: end]
        else:  # pad: wrap around to the beginning (reference round_batch)
            idx = np.concatenate(
                [self._order[self.cursor:], self._order[: end - self.num_data]])
        # float32, as the JAX package's nd.array makes every batch
        return np.ascontiguousarray(arr[idx], dtype=np.float32)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0

    @property
    def provide_data(self):
        return [(self.data_name, (self.batch_size,) + self.data.shape[1:])]

    @property
    def provide_label(self):
        return [(self.label_name, (self.batch_size,) + self.label.shape[1:])]


def _read_idx_file(path):
    # GzipFile does not close a passed fileobj: both levels need closing
    with open_uri(path, "rb") as raw, \
            (gzip.open(raw, "rb") if path.endswith(".gz") else raw) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise MXNetError(f"{path}: not an idx file")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        # native byte order, as the JAX package reads (MNIST is uint8)
        data = np.frombuffer(f.read(), dtype=dtype)
        return data.reshape(dims)


class _Wrapped(DataIter):
    """An iterator that hands every call to an inner ``NDArrayIter``."""

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def getpad(self):
        return self._inner.getpad()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class MNISTIter(_Wrapped):
    """MNIST idx files, flat or 4-D, shuffled, sharded by ``num_parts`` /
    ``part_index`` (``mxnet_tpu/io/__init__.py:187-245``)."""

    params = {
        "image": (str, REQUIRED, "idx-format image file (.gz ok)"),
        "label": (str, REQUIRED, "idx-format label file (.gz ok)"),
        "batch_size": (Range(int, lo=1), 128, "batch size"),
        "shuffle": (bool, False, "shuffle each epoch"),
        "flat": (bool, False, "emit (n, 784) instead of (n, 1, 28, 28)"),
        "seed": (int, 0, "shuffle RNG seed"),
        "silent": (bool, True, "suppress loading logs (parity flag)"),
        "num_parts": (Range(int, lo=1), 1, "number of distributed shards"),
        "part_index": (Range(int, lo=0), 0, "this worker's shard index"),
        "input_shape": (TupleParam(3), None, "reshape images to this (c, h, w)"),
    }

    def __init__(self, **kwargs):
        super().__init__()
        cfg = apply_params(type(self).__name__, type(self).params, kwargs)
        num_parts, part_index = cfg["num_parts"], cfg["part_index"]
        images = _read_idx_file(cfg["image"]).astype(np.float32) / 255.0
        labels = _read_idx_file(cfg["label"]).astype(np.float32)
        n = images.shape[0]
        per = n // num_parts
        lo = per * part_index
        hi = per * (part_index + 1) if part_index < num_parts - 1 else n
        images, labels = images[lo:hi], labels[lo:hi]
        if cfg["flat"]:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1],
                                    images.shape[2])
            shape = cfg["input_shape"]
            if shape is not None and tuple(shape) != images.shape[1:]:
                images = images.reshape((images.shape[0],) + tuple(shape))
        self._inner = NDArrayIter(
            images, labels, batch_size=cfg["batch_size"],
            shuffle=cfg["shuffle"],
            seed=cfg["seed"] if cfg["shuffle"] else None)
        self.batch_size = cfg["batch_size"]


class CSVIter(_Wrapped):
    """Batches of the rows of a CSV file, each reshaped to ``data_shape``."""

    params = {
        "data_csv": (str, REQUIRED, "CSV file of flattened rows"),
        "data_shape": (TupleParam(), REQUIRED, "per-row shape"),
        "label_csv": (str, None, "CSV label file (zeros when absent)"),
        "batch_size": (Range(int, lo=1), 128, "batch size"),
        "round_batch": (bool, True, "accepted for parity"),
    }

    def __init__(self, **kwargs):
        super().__init__()
        cfg = apply_params(type(self).__name__, type(self).params, kwargs)
        with open_uri(cfg["data_csv"], "rb") as f:
            data = np.loadtxt(f, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(cfg["data_shape"]))
        if cfg["label_csv"]:
            with open_uri(cfg["label_csv"], "rb") as f:
                label = np.loadtxt(f, delimiter=",", dtype=np.float32)
        else:
            label = np.zeros((data.shape[0],), np.float32)
        self._inner = NDArrayIter(data, label, batch_size=cfg["batch_size"])
        self.batch_size = cfg["batch_size"]

    def getpad(self):
        return 0


def _parse_rotate_list(v):
    """``rotate_list`` as a list of ints, from a list or the reference's
    comma-separated string ("90,180,270")."""
    if v is None:
        return None
    if isinstance(v, str):
        vals = [int(x) for x in v.split(",") if x.strip()]
    else:
        vals = [int(x) for x in v]
    return vals or None


class ImageRecordIter(DataIter):
    """Images from RecordIO shards with augmentation.

    Per image: record read -> decode -> [resize the shorter side] ->
    [random scale / size clamps] -> [rotation, shear] -> [random or centre
    crop to ``data_shape``] -> [mirror] -> [HSL jitter] -> mean / contrast /
    illumination / scale -> CHW or HWC, float32 or raw uint8.

    JPEG records take the native pipeline (``native.NativePipeline``,
    ``preprocess_threads`` C++ threads; its batches are pinned on a host
    with a card) when ``MXNET_TPU_NATIVE_IO`` is on (the default), the mean
    is per channel, no Python-only augmenter (rotation, shear, aspect, HSL,
    random-sized crop) is set and the file is local. Its random draws are
    the JAX native pipeline's: deterministic for a seed with one thread, or
    with no random augmentation. Otherwise each batch is one task on the
    host engine with its own ``RandomState``, seeded from the iterator's on
    the main thread, so the batches do not depend on the threads' order."""

    params = {
        "path_imgrec": (str, REQUIRED, "RecordIO shard path"),
        "data_shape": (TupleParam(3), REQUIRED,
                       "(c, h, w) emitted image shape (``layout`` selects "
                       "the batch layout)"),
        "batch_size": (Range(int, lo=1), REQUIRED, "batch size"),
        "label_width": (Range(int, lo=1), 1, "labels per record"),
        "shuffle": (bool, False, "shuffle record order each epoch"),
        "mean_img": (str, None, "mean-image cache path (computed+saved on "
                                "first use, loaded after)"),
        "mean_r": (float, 0.0, "per-channel mean (red)"),
        "mean_g": (float, 0.0, "per-channel mean (green)"),
        "mean_b": (float, 0.0, "per-channel mean (blue)"),
        "scale": (float, 1.0, "multiplier applied after mean subtraction"),
        "rand_crop": (bool, False, "random (vs center) crop"),
        "rand_mirror": (bool, False, "random horizontal flip"),
        "resize": (int, -1, "resize shorter side to this before crop (-1 off)"),
        "max_rotate_angle": (Range(int, lo=0), 0, "max random rotation (deg)"),
        "rotate": (int, -1, "fixed rotation angle in degrees (>0 overrides "
                            "max_rotate_angle)"),
        "rotate_list": (_parse_rotate_list, None,
                        "angles to pick from uniformly, list or "
                        "comma-separated string (overrides rotate/"
                        "max_rotate_angle)"),
        "max_aspect_ratio": (Range(float, lo=0.0), 0.0, "max aspect jitter"),
        "max_shear_ratio": (Range(float, lo=0.0), 0.0, "max shear jitter"),
        "min_random_scale": (Range(float, lo=0.0), 1.0,
                             "min random resize-scale factor"),
        "max_random_scale": (Range(float, lo=0.0), 1.0,
                             "max random resize-scale factor"),
        "min_img_size": (Range(float, lo=0.0), 0.0,
                         "clamp each image dimension to at least this "
                         "after scaling (0 off)"),
        "max_img_size": (Range(float, lo=0.0), 0.0,
                         "clamp each image dimension to at most this "
                         "after scaling (0 off)"),
        "max_random_contrast": (Range(float, lo=0.0), 0.0,
                                "contrast jitter: pixel = (pixel - mean) * c "
                                "+ i with c ~ U[1-x, 1+x]"),
        "max_random_illumination": (Range(float, lo=0.0), 0.0,
                                    "illumination jitter: i ~ U[-x, x] "
                                    "(0-255 pixel units)"),
        "mirror": (bool, False, "always mirror horizontally (vs rand_mirror)"),
        "min_crop_size": (int, -1, "min random crop size (-1 off)"),
        "max_crop_size": (int, -1, "max random crop size (-1 off)"),
        "random_h": (Range(int, lo=0), 0, "max hue jitter (degrees)"),
        "random_s": (Range(int, lo=0), 0, "max saturation jitter (0-255)"),
        "random_l": (Range(int, lo=0), 0, "max lightness jitter (0-255)"),
        "fill_value": (Range(int, lo=0, hi=255), 255, "border fill value"),
        "num_parts": (Range(int, lo=1), 1, "number of distributed shards"),
        "part_index": (Range(int, lo=0), 0, "this worker's shard index"),
        "round_batch": (bool, True, "wrap the last batch around the epoch"),
        "seed": (int, 0, "augmentation/shuffle RNG seed"),
        "preprocess_threads": (int, None, "decode worker threads of the "
                                          "native route (default: "
                                          "MXNET_CPU_WORKER_NTHREADS when "
                                          "set, else one less than the "
                                          "host's cores); the Python path "
                                          "decodes on the host engine"),
        "prefetch_buffer": (Range(int, lo=1), 4, "prefetched batches"),
        "path_imglist": (str, None, "accepted for parity (unused: labels "
                                    "ride in the RecordIO headers)"),
        "layout": (("NCHW", "NHWC"), "NCHW", "emitted batch layout"),
        "output_dtype": (("float32", "uint8"), "float32",
                         "batch dtype (uint8 = raw pixels, 4x less "
                         "host->device traffic; normalise on the device)"),
    }

    # reference flags with no effect, accepted with a warning
    tolerated = ("verbose", "crop_x_start", "crop_y_start")

    def __init__(self, **kwargs):
        super().__init__()
        from .. import recordio as rio

        cfg = apply_params(type(self).__name__, type(self).params, kwargs,
                           tolerated=type(self).tolerated)
        path_imgrec = cfg["path_imgrec"]
        mean_img = cfg["mean_img"]
        mean_r, mean_g, mean_b = cfg["mean_r"], cfg["mean_g"], cfg["mean_b"]
        num_parts, part_index = cfg["num_parts"], cfg["part_index"]
        self.layout = cfg["layout"]
        self.output_dtype = cfg["output_dtype"]
        if self.output_dtype == "uint8" and (
                mean_img is not None or mean_r or mean_g or mean_b
                or cfg["scale"] != 1.0 or cfg["max_random_contrast"]
                or cfg["max_random_illumination"]):
            raise MXNetError(
                "ImageRecordIter: output_dtype='uint8' emits raw pixels; "
                "mean/scale normalization and contrast/illumination jitter "
                "must run on the device instead")
        self.data_shape = tuple(cfg["data_shape"])
        self.batch_size = cfg["batch_size"]
        for key in ("label_width", "shuffle", "scale", "rand_crop",
                    "rand_mirror", "resize", "max_rotate_angle", "rotate",
                    "rotate_list", "min_random_scale", "max_random_scale",
                    "min_img_size", "max_img_size", "max_random_contrast",
                    "max_random_illumination", "mirror", "max_aspect_ratio",
                    "max_shear_ratio", "min_crop_size", "max_crop_size",
                    "random_h", "random_s", "random_l", "fill_value",
                    "round_batch"):
            setattr(self, key, cfg[key])
        if self.max_random_scale < self.min_random_scale:
            raise MXNetError(
                "max_random_scale must be >= min_random_scale, got "
                f"({self.min_random_scale}, {self.max_random_scale})")
        if 0 < self.max_img_size < self.min_img_size:
            raise MXNetError(
                "max_img_size must be >= min_img_size when both are set, "
                f"got ({self.min_img_size}, {self.max_img_size})")
        if (self.min_crop_size > 0) != (self.max_crop_size > 0) or \
                (self.min_crop_size > 0
                 and self.max_crop_size < self.min_crop_size):
            raise MXNetError(
                "min_crop_size/max_crop_size must be set together with "
                f"min <= max, got ({self.min_crop_size}, "
                f"{self.max_crop_size})")
        self._rng = np.random.RandomState(cfg["seed"])
        self._mean = None
        compute_mean = None
        if mean_img is not None:
            if os.path.exists(mean_img):
                self._mean = self._load_mean(mean_img)
            else:
                compute_mean = mean_img  # one pass below, then cached
        elif mean_r or mean_g or mean_b:
            self._mean = np.array([mean_r, mean_g, mean_b],
                                  np.float32).reshape(3, 1, 1)
        offsets = rio.scan_offsets(path_imgrec)
        per = len(offsets) // num_parts
        lo = per * part_index
        hi = per * (part_index + 1) if part_index < num_parts - 1 \
            else len(offsets)
        self._offsets = offsets[lo:hi]
        if not self._offsets:
            raise MXNetError(f"no records in shard {part_index}/{num_parts}")
        self._path = path_imgrec
        self._prefetch_depth = max(1, min(int(cfg["prefetch_buffer"]), 16))
        self._pad = 0
        if compute_mean is not None:
            if part_index == 0:
                # over every record, so that every worker normalises alike
                self._mean = self._compute_and_cache_mean(compute_mean,
                                                          offsets)
            else:
                self._mean = self._wait_for_mean(
                    compute_mean, fallback=lambda: self._compute_and_cache_mean(
                        compute_mean, offsets))
        # JPEG records take the native pipeline under the JAX package's
        # conditions; it probes one batch and falls back to the Python path
        # when it cannot take the records
        self._native = None
        self._native_first = None
        if (env_int("MXNET_TPU_NATIVE_IO", 1) and self._mean_is_rgb()
                and not self._needs_py_augment()
                and not is_remote_uri(path_imgrec)
                and self._records_look_jpeg()):
            self._native = self._open_native(cfg)
        self.reset()

    def _open_native(self, cfg):
        from .. import native

        threads = cfg["preprocess_threads"] or (
            env_int("MXNET_CPU_WORKER_NTHREADS", 0) or None)
        try:
            pipe = native.NativePipeline(
                self._path, self._offsets, self.batch_size, self.data_shape,
                label_width=self.label_width, rand_crop=self.rand_crop,
                rand_mirror=self.rand_mirror, resize=self.resize,
                mean=(self._mean.ravel() if self._mean is not None
                      else None),
                scale=self.scale, shuffle=self.shuffle, seed=cfg["seed"],
                num_threads=threads, prefetch=self._prefetch_depth,
                round_batch=self.round_batch,
                nhwc=(self.layout == "NHWC"),
                out_u8=(self.output_dtype == "uint8"),
                min_random_scale=self.min_random_scale,
                max_random_scale=self.max_random_scale,
                min_img_size=self.min_img_size,
                max_img_size=self.max_img_size,
                max_random_contrast=self.max_random_contrast,
                max_random_illumination=self.max_random_illumination,
                mirror=self.mirror)
            self._native_first = pipe.next()  # the probe batch
        except (MXNetError, StopIteration) as e:
            logging.warning("ImageRecordIter: the native pipeline cannot "
                            "take %r (%s); decoding in Python", self._path, e)
            self._native_first = None
            return None
        return pipe

    def _mean_is_rgb(self):
        return self._mean is None or self._mean.size == 3

    def _needs_py_augment(self):
        """Rotation, shear, aspect jitter, HSL jitter and random-sized crops
        exist in the Python path only."""
        return bool(self.max_rotate_angle or self.rotate > 0
                    or self.rotate_list or self.max_aspect_ratio
                    or self.max_shear_ratio or self.random_h or self.random_s
                    or self.random_l or self.min_crop_size > 0)

    def _records_look_jpeg(self, sample=16):
        """The image magic of up to ``sample`` evenly spaced records is
        JPEG's, so that a file that mixes formats stays on the Python
        path."""
        n = len(self._offsets)
        idxs = range(n) if n <= sample else \
            [int(i * (n - 1) / (sample - 1)) for i in range(sample)]
        try:
            with open_uri(self._path, "rb") as f:
                for i in idxs:
                    f.seek(self._offsets[i] + 16)  # past the record header
                    flag = struct.unpack("<I", f.read(4))[0]
                    # the rest of the 24-byte image header, then any labels
                    f.seek(20 + (flag * 4 if flag > 0 else 0), 1)
                    if f.read(2) != b"\xff\xd8":
                        return False
        except (OSError, struct.error):
            return False
        return True

    @staticmethod
    def _load_mean(path):
        from .. import ndarray as nd

        return nd.load(path)["mean_img"].numpy()

    def _compute_and_cache_mean(self, path, offsets):
        """The mean image at ``data_shape`` (resize the shorter side, centre
        crop, nothing random) over every record, saved CHW under key
        ``mean_img`` in the NDArray format, atomically; a cache that
        appeared meanwhile (another worker's) is loaded instead. A
        ``path + '.inprogress'`` marker, touched every 20 s, tells waiting
        workers that the pass is alive."""
        from .. import ndarray as nd
        from .. import recordio as rio

        c, th, tw = self.data_shape
        marker = f"{path}.inprogress"
        try:
            with open(marker, "a"):
                pass
        except OSError:
            marker = None
        acc = np.zeros((th, tw, c), np.float64)
        last_touch = _time.monotonic()
        with open_uri(self._path, "rb") as f:
            for off in offsets:
                if marker is not None and _time.monotonic() - last_touch > 20.0:
                    last_touch = _time.monotonic()
                    try:
                        os.utime(marker)
                    except OSError:
                        pass
                _, img = rio.unpack_img(rio.read_record_at(f, off))
                h, w = img.shape[:2]
                if self.resize > 0:
                    s = self.resize / min(h, w)
                    img = _imaging.resize(
                        img, (max(tw, int(w * s)), max(th, int(h * s))))
                    h, w = img.shape[:2]
                if h < th or w < tw:
                    img = _imaging.resize(img, (tw, th))
                    h, w = img.shape[:2]
                top, left = (h - th) // 2, (w - tw) // 2
                acc += img[top:top + th, left:left + tw].astype(np.float64)
        mean = (acc / len(offsets)).astype(np.float32).transpose(2, 0, 1)
        try:
            if os.path.exists(path):  # another worker won the race
                return self._load_mean(path)
            tmp = f"{path}.tmp.{os.getpid()}"
            nd.save(tmp, {"mean_img": torch.from_numpy(
                np.ascontiguousarray(mean))})
            os.replace(tmp, path)
        finally:
            if marker is not None:
                try:
                    os.unlink(marker)
                except OSError:
                    pass
        logging.info("ImageRecordIter: computed mean image over %d records, "
                     "saved to %s", len(offsets), path)
        return mean

    def _wait_for_mean(self, path, grace=120.0, timeout=3600.0, poll=1.0,
                       fallback=None):
        """Wait for worker 0's mean cache. With its ``.inprogress`` marker
        seen and fresh, wait up to ``timeout``; with neither cache nor
        marker after ``grace`` seconds (``MXNET_TPU_MEAN_WAIT_SEC``), or a
        marker gone stale (90 s without a touch), there is no live worker 0
        on a shared filesystem: ``fallback`` computes the mean here."""
        grace = float(os.environ.get("MXNET_TPU_MEAN_WAIT_SEC", grace))
        marker = f"{path}.inprogress"
        start = _time.monotonic()
        seen_marker = False
        stale_after = 90.0
        while not os.path.exists(path):
            marker_live = False
            try:
                marker_live = (_time.time() - os.stat(marker).st_mtime
                               < stale_after)
            except OSError:
                pass
            seen_marker = seen_marker or marker_live
            if seen_marker and not marker_live and not os.path.exists(marker):
                # worker 0 finished or died: one more poll for the cache
                seen_marker = False
                _time.sleep(poll)
                continue
            waited = _time.monotonic() - start
            if seen_marker and not marker_live and waited > grace:
                if fallback is not None:
                    logging.warning(
                        "ImageRecordIter: mean-image marker %r is stale; "
                        "computing the mean locally", marker)
                    return fallback()
                raise MXNetError(
                    f"mean image marker {marker!r} is stale — the "
                    "part_index=0 worker appears to have died while "
                    "computing; restart it or remove the marker")
            if not seen_marker and waited > grace:
                if fallback is not None:
                    logging.warning(
                        "ImageRecordIter: neither mean image cache %r nor "
                        "its marker appeared within %.0fs; computing the "
                        "mean locally", path, grace)
                    return fallback()
                raise MXNetError(
                    f"timed out waiting for mean image cache {path!r} "
                    "(is the part_index=0 worker running, and does it share "
                    "a filesystem with this worker? Set "
                    "MXNET_TPU_MEAN_WAIT_SEC to adjust the wait.)")
            if waited > timeout:
                raise MXNetError(
                    f"timed out after {timeout:.0f}s waiting for mean image "
                    f"cache {path!r}")
            _time.sleep(poll)
        return self._load_mean(path)

    def reset(self):
        self._pad = 0
        if self._native is not None:
            if self._native_first is None:  # keep the probe batch at first
                self._native.reset()
            return
        self._order = np.arange(len(self._offsets))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self.cursor = 0
        self._pending = collections.deque()
        self._pad = 0
        for _ in range(self._prefetch_depth):
            self._enqueue()

    def _decode_one(self, raw, rng):
        """One record as ``(image, label)``, the JAX package's
        ``_decode_one`` draw for draw."""
        from .. import recordio as rio

        header, img = rio.unpack_img(raw)
        img = img.astype(np.float32)
        c, target_h, target_w = self.data_shape
        if self.resize > 0:
            h, w = img.shape[:2]
            s = self.resize / min(h, w)
            img = _imaging.resize(
                img.astype(np.uint8),
                (max(target_w, int(w * s)), max(target_h, int(h * s)))
            ).astype(np.float32)
        if (self.min_random_scale != 1.0 or self.max_random_scale != 1.0
                or self.min_img_size > 0 or self.max_img_size > 0):
            h, w = img.shape[:2]
            s = rng.uniform(self.min_random_scale, self.max_random_scale) \
                if (self.min_random_scale != 1.0
                    or self.max_random_scale != 1.0) else 1.0
            nh, nw = h * s, w * s
            if self.min_img_size > 0:
                nh, nw = max(nh, self.min_img_size), max(nw, self.min_img_size)
            if self.max_img_size > 0:
                nh, nw = min(nh, self.max_img_size), min(nw, self.max_img_size)
            nh = max(target_h, int(nh + 0.5))
            nw = max(target_w, int(nw + 0.5))
            if (nh, nw) != (h, w):
                img = _imaging.resize(img.astype(np.uint8),
                                      (nw, nh)).astype(np.float32)
        if (self.max_rotate_angle or self.max_shear_ratio or self.rotate > 0
                or self.rotate_list):
            pix = img.astype(np.uint8)
            fill = tuple([int(self.fill_value)] * 3)
            # rotate_list > fixed rotate > uniform +-max_rotate_angle
            if self.rotate_list:
                angle = float(self.rotate_list[
                    rng.randint(0, len(self.rotate_list))])
            elif self.rotate > 0:
                angle = float(self.rotate)
            elif self.max_rotate_angle:
                angle = rng.uniform(-self.max_rotate_angle,
                                    self.max_rotate_angle)
            else:
                angle = 0.0
            if angle:
                pix = _imaging.rotate(pix, angle, fill)
            if self.max_shear_ratio:
                s = rng.uniform(-self.max_shear_ratio, self.max_shear_ratio)
                pix = _imaging.affine(pix, (1, s, 0, 0, 1, 0), fill)
            img = pix.astype(np.float32)
        h, w = img.shape[:2]
        if h < target_h or w < target_w:
            img = _imaging.resize(img.astype(np.uint8),
                                  (target_w, target_h)).astype(np.float32)
            h, w = img.shape[:2]
        crop_h, crop_w = target_h, target_w
        if self.min_crop_size > 0:
            size = rng.randint(self.min_crop_size, self.max_crop_size + 1)
            crop_h = crop_w = size
        if self.max_aspect_ratio > 0:
            ratio = 1.0 + rng.uniform(-self.max_aspect_ratio,
                                      self.max_aspect_ratio)
            crop_w = max(1, int(crop_w * ratio))
        crop_h, crop_w = min(crop_h, h), min(crop_w, w)
        if self.rand_crop:
            top = rng.randint(0, h - crop_h + 1)
            left = rng.randint(0, w - crop_w + 1)
        else:
            top, left = (h - crop_h) // 2, (w - crop_w) // 2
        img = img[top: top + crop_h, left: left + crop_w]
        if (crop_h, crop_w) != (target_h, target_w):
            img = _imaging.resize(img.astype(np.uint8),
                                  (target_w, target_h)).astype(np.float32)
        if self.mirror or (self.rand_mirror and rng.rand() < 0.5):
            img = img[:, ::-1]
        if self.random_h or self.random_s or self.random_l:
            img = self._hsl_jitter(img, rng)
        if self.layout == "NHWC":
            if self._mean is not None:
                mean = self._mean if self._mean.ndim == 3 \
                    else self._mean.reshape(3, 1, 1)
                img = img - mean.transpose(1, 2, 0)
        else:
            img = img.transpose(2, 0, 1)
            if self._mean is not None:
                img = img - (self._mean if self._mean.ndim == 3
                             else self._mean.reshape(3, 1, 1))
        if self.max_random_contrast or self.max_random_illumination:
            # after the mean, before scale: ((x - mean) * c + i) * scale
            con = 1.0 + rng.uniform(-self.max_random_contrast,
                                    self.max_random_contrast) \
                if self.max_random_contrast else 1.0
            ill = rng.uniform(-self.max_random_illumination,
                              self.max_random_illumination) \
                if self.max_random_illumination else 0.0
            img = img * con + ill
        img = img * self.scale
        label = header.label if header.flag > 0 else np.float32(header.label)
        return img.astype(self._np_dtype), label

    def _hsl_jitter(self, img, rng):
        """Random hue (degrees), saturation and lightness (0-255 units)
        shifts in HLS space."""
        dh = rng.uniform(-self.random_h, self.random_h) if self.random_h else 0.0
        ds = rng.uniform(-self.random_s, self.random_s) if self.random_s else 0.0
        dl = rng.uniform(-self.random_l, self.random_l) if self.random_l else 0.0
        x = np.clip(img, 0, 255) / 255.0
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        mx_, mn = x.max(axis=-1), x.min(axis=-1)
        c = mx_ - mn
        light = (mx_ + mn) / 2.0
        s = np.where(c > 0, c / np.maximum(1.0 - np.abs(2 * light - 1), 1e-12),
                     0.0)
        hr = np.where(c > 0, np.mod((g - b) / np.maximum(c, 1e-12), 6.0), 0.0)
        hg = (b - r) / np.maximum(c, 1e-12) + 2.0
        hb = (r - g) / np.maximum(c, 1e-12) + 4.0
        hue = np.where(mx_ == r, hr, np.where(mx_ == g, hg, hb))
        hue = np.mod(hue + dh / 60.0, 6.0)
        s = np.clip(s + ds / 255.0, 0.0, 1.0)
        light = np.clip(light + dl / 255.0, 0.0, 1.0)
        c2 = (1.0 - np.abs(2 * light - 1)) * s
        xm = c2 * (1 - np.abs(np.mod(hue, 2.0) - 1))
        m = light - c2 / 2.0
        z = np.zeros_like(c2)
        idx = np.floor(hue).astype(np.int32) % 6
        rgb = np.stack([
            np.choose(idx, [c2, xm, z, z, xm, c2]),
            np.choose(idx, [xm, c2, c2, xm, z, z]),
            np.choose(idx, [z, z, xm, c2, c2, xm]),
        ], axis=-1) + m[..., None]
        return (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.float32)

    def _enqueue(self):
        """Push the production of one batch to the host engine."""
        if self.cursor >= len(self._order):
            return
        end = self.cursor + self.batch_size
        idx = self._order[self.cursor: end]
        pad = 0
        if end > len(self._order):
            if self.round_batch:
                pad = end - len(self._order)
                idx = np.concatenate([idx, self._order[:pad]])
            else:
                self.cursor = len(self._order)
                return
        self.cursor = end
        offs = [self._offsets[i] for i in idx]
        # each task's own generator, seeded here on the main thread
        task_seed = int(self._rng.randint(0, 2**31 - 1))

        def produce(offs=offs, pad=pad, task_seed=task_seed):
            from .. import recordio as rio

            rng = np.random.RandomState(task_seed)
            data = np.empty((len(offs),) + self._batch_shape, self._np_dtype)
            labels = np.empty(
                (len(offs),) if self.label_width == 1
                else (len(offs), self.label_width), np.float32)
            with open_uri(self._path, "rb") as f:
                for i, off in enumerate(offs):
                    data[i], labels[i] = self._decode_one(
                        rio.read_record_at(f, off), rng)
            return data, labels, pad

        self._pending.append(engine().push(produce))

    def next(self):
        if self._native is not None:
            if self._native_first is not None:
                data, labels, pad = self._native_first
                self._native_first = None
            else:
                data, labels, pad = self._native.next()
            self._pad = pad
            return DataBatch([data], [labels], pad=pad)
        if not self._pending:
            raise StopIteration
        data, labels, pad = self._pending.popleft().result()
        self._enqueue()
        self._pad = pad
        return DataBatch([torch.from_numpy(data)], [torch.from_numpy(labels)],
                         pad=pad)

    def getpad(self):
        return self._pad

    @property
    def _np_dtype(self):
        return np.uint8 if self.output_dtype == "uint8" else np.float32

    @property
    def _batch_shape(self):
        c, h, w = self.data_shape
        return (h, w, c) if self.layout == "NHWC" else (c, h, w)

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self._batch_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [("softmax_label", shape)]


class PrefetchingIter(DataIter):
    """Runs the wrapped iterator up to ``depth`` batches ahead on the host
    engine (``MXNET_PREFETCH_BUFFER``, default 4). Every ``next`` of the
    wrapped iterator writes one engine variable, so they run in order; a
    ``reset`` drains what is in flight first."""

    def __init__(self, iter_, depth=None):
        super().__init__()
        self._iter = iter_
        self.batch_size = iter_.batch_size
        self._depth = depth or env_int("MXNET_PREFETCH_BUFFER", 4)
        self._queue = collections.deque()
        self._exhausted = True
        self._var = engine().new_variable("prefetch-iter")

    def reset(self):
        for fut in self._queue:
            try:
                fut.result()
            except StopIteration:
                pass
        self._queue.clear()
        self._iter.reset()
        self._exhausted = False
        for _ in range(self._depth):
            self._fill()

    def _fill(self):
        if self._exhausted:
            return
        self._queue.append(engine().push(self._iter.next,
                                         write_vars=[self._var]))

    def next(self):
        import time as _time

        from .. import telemetry

        while self._queue:
            fut = self._queue.popleft()
            t0 = _time.perf_counter()
            try:
                batch = fut.result()
            except StopIteration:
                self._exhausted = True
                continue
            # prefetch-stall accounting: with the producer keeping up this
            # wait is ~0; a positive tail is the data pipeline failing to
            # hide under compute (the badput 'data_wait' side)
            telemetry.counter("io_prefetch_wait_seconds_total",
                              _time.perf_counter() - t0)
            telemetry.counter("io_prefetch_batches_total")
            self._fill()
            return batch
        raise StopIteration

    def getpad(self):
        return self._iter.getpad()

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label


for _cls in (MNISTIter, ImageRecordIter, CSVIter):
    autodoc(_cls)
del _cls
