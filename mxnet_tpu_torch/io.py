"""Data iterators.

Counterpart of ``DataBatch``, ``DataIter`` and ``NDArrayIter`` in
``mxnet_tpu/io/__init__.py:42-172``: in-memory batching with the reference's
pad semantics (the last partial batch wraps around to the epoch start and
reports ``pad``, the number of wrapped rows) or ``roll_over``. Batches hold
float32 CPU tensors; the trainer moves them to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["DataBatch", "DataIter", "NDArrayIter"]


class DataBatch:
    """One batch: data and label tensors and the pad count."""

    def __init__(self, data, label, pad=0, index=None):
        self.data = data if isinstance(data, list) else [data]
        self.label = label if isinstance(label, list) else [label]
        self.pad = pad
        self.index = index


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
