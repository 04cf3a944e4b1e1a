"""Bucketing: variable-length sequence training over one shared weight set.

Counterpart of ``mxnet_tpu/bucketing.py`` (reference: example/rnn/lstm.py's
executor per sequence length):

- ``BucketSentenceIter`` puts each tokenised sentence in the smallest
  bucket that fits it (longer ones are dropped and counted in
  ``discarded``), pads it with ``invalid_label`` and yields batches tagged
  with ``bucket_key`` and per-step ``t{i}_data`` / ``t{i}_label`` names,
  as ``models.lstm_unroll`` names its inputs;
- ``BucketingFeedForward`` is a ``FeedForward`` whose graph comes from
  ``sym_gen(bucket_key)``, one a bucket, all reading the parameters
  initialised from the default (largest) bucket.

``PadPolicy`` (``utils/compile.py``) assigns the buckets: ``"bucket"``
(the smallest bucket that fits) or ``"pow2"`` (the next power of two,
which bounds the number of buckets at log2 of the longest sentence).
``BucketSentenceIter.bucket_shapes`` lists the programs a fit over the
iterator needs, which ``BucketingFeedForward.precompile(data=it)``
captures: one CUDA graph a bucket, every graph reading the one set of
parameter buffers, each with a memory pool of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import DataBatch, DataIter
from .model import FeedForward
from .utils.compile import PadPolicy

__all__ = ["BucketSentenceIter", "BucketingFeedForward", "PadPolicy"]


class BucketSentenceIter(DataIter):
    """Bucketed language-model iterator: labels are the data shifted by one
    token, and positions past a sentence's end hold ``invalid_label``.
    ``init_states`` (``(name, shape)`` pairs) ride along as zeros, the
    recurrent states' initial values. ``pad_policy="pow2"`` with
    ``buckets=None`` derives the buckets from the data."""

    def __init__(self, sentences, buckets=None, batch_size=32,
                 invalid_label=0, init_states=None, shuffle=True, seed=0,
                 pad_policy=None):
        super().__init__()
        if isinstance(pad_policy, str):
            pad_policy = PadPolicy(pad_policy)
        self.pad_policy = pad_policy
        sentences = list(sentences)
        if buckets is None:
            if pad_policy is None or pad_policy.mode != "pow2":
                raise ValueError(
                    "BucketSentenceIter: pass buckets=[...] (or "
                    "pad_policy='pow2' to derive power-of-two buckets "
                    "from the data)")
            buckets = sorted({pad_policy.round_length(len(s))
                              for s in sentences if len(s) > 0})
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.init_states = list(init_states or [])
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        per_bucket = {b: [] for b in self.buckets}
        self.discarded = 0
        for sent in sentences:
            b = self._assign_bucket(len(sent))
            if b is None:
                self.discarded += 1
            else:
                per_bucket[b].append(sent)
        self._data = {}
        for b, sents in per_bucket.items():
            if not sents:
                continue
            mat = np.full((len(sents), b + 1), invalid_label, np.int32)
            for i, s in enumerate(sents):
                mat[i, : len(s)] = s
            self._data[b] = mat
        self.default_bucket_key = self.buckets[-1]
        self._plan = []
        self.reset()

    def _assign_bucket(self, length):
        if self.pad_policy is not None:
            return self.pad_policy.round_length(length, self.buckets)
        for b in self.buckets:
            if length <= b:
                return b
        return None

    def bucket_shapes(self):
        """``(bucket_key, data_shapes, label_shapes)`` of every non-empty
        bucket: the programs a fit over this iterator captures (token ids as
        int32, the initial states as float32 shapes)."""
        out = []
        for b in sorted(self._data):
            data = {f"t{i}_data": ((self.batch_size,), np.int32)
                    for i in range(b)}
            data.update({name: tuple(shape)
                         for name, shape in self.init_states})
            label = {f"t{i}_label": ((self.batch_size,), np.int32)
                     for i in range(b)}
            out.append((b, data, label))
        return out

    @property
    def provide_data(self):
        """The default (largest) bucket's inputs."""
        return [(f"t{i}_data", (self.batch_size,))
                for i in range(self.default_bucket_key)] + self.init_states

    @property
    def provide_label(self):
        return [(f"t{i}_label", (self.batch_size,))
                for i in range(self.default_bucket_key)]

    def reset(self):
        self._plan = []
        for b, mat in self._data.items():
            idx = np.arange(len(mat))
            if self.shuffle:
                self._rng.shuffle(idx)
            for start in range(0, len(idx), self.batch_size):
                self._plan.append((b, idx[start:start + self.batch_size]))
        if self.shuffle:
            self._rng.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bucket, rows = self._plan[self._cursor]
        self._cursor += 1
        mat = self._data[bucket][rows]
        pad = self.batch_size - len(mat)
        if pad:
            mat = np.concatenate([mat, np.repeat(mat[-1:], pad, axis=0)])
        mat = torch.from_numpy(np.ascontiguousarray(mat.T))  # [b + 1, batch]
        batch = DataBatch(
            data=[mat[t] for t in range(bucket)]
            + [torch.zeros(shape, dtype=torch.float32)
               for _, shape in self.init_states],
            label=[mat[t + 1] for t in range(bucket)],
            pad=pad)
        batch.bucket_key = bucket
        batch.data_names = [f"t{t}_data" for t in range(bucket)] + \
            [name for name, _ in self.init_states]
        batch.label_names = [f"t{t}_label" for t in range(bucket)]
        return batch


class BucketingFeedForward(FeedForward):
    """A FeedForward over ``sym_gen(bucket_key)``: parameters initialised
    from ``sym_gen(default_bucket_key)``, and each bucket's graph built at
    its first batch and kept, all reading the same parameters."""

    def __init__(self, sym_gen, default_bucket_key, **kwargs):
        self._sym_gen = sym_gen
        self._bucket_syms = {}
        self.default_bucket_key = default_bucket_key
        super().__init__(symbol=self._symbol_for_bucket(default_bucket_key),
                         **kwargs)

    def _symbol_for_bucket(self, bucket_key):
        if bucket_key is None:
            bucket_key = self.default_bucket_key
        if bucket_key not in self._bucket_syms:
            self._bucket_syms[bucket_key] = self._sym_gen(bucket_key)
        return self._bucket_syms[bucket_key]
