"""``FeedForward.fit``'s device feed and the cast of its data inputs.

- A uint8 image batch under ``compute_dtype=torch.bfloat16`` enters the
  graph in bf16, as the JAX package casts every ``data_names`` input
  (``mxnet_tpu/model.py:673``): the step equals the one on the same pixels
  given as float32 0..255, bit for bit (tolerance 0).
- The threaded feed and the synchronous one (``MXTPU_FEED_PREFETCH=0``)
  train to the same parameters bit for bit; the batch each step reads is
  the host batch; an iterator's error surfaces in ``fit`` and the feed
  thread is joined.
- On the card (``cuda``): the batch each step read on the card equals the
  host batch, by an exact integer digest of both.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import model as model_mod
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params

BATCH, SIDE = 4, 32


class _Batches(tio.DataIter):
    """Fixed batches of the given dtype, fresh tensors every epoch."""

    def __init__(self, images, labels, dtype, fail_at=None):
        super().__init__()
        self.images, self.labels, self.dtype = images, labels, dtype
        self.batch_size = BATCH
        self.fail_at = fail_at
        self._i = 0

    def reset(self):
        self._i = 0

    def next(self):
        if self._i == self.fail_at:
            raise RuntimeError("the iterator broke")
        if self._i * BATCH >= len(self.images):
            raise StopIteration
        sl = slice(self._i * BATCH, (self._i + 1) * BATCH)
        self._i += 1
        return tio.DataBatch(
            [torch.from_numpy(self.images[sl].astype(self.dtype))],
            [torch.from_numpy(self.labels[sl])])

    @property
    def provide_data(self):
        return [("data", (BATCH,) + self.images.shape[1:])]

    @property
    def provide_label(self):
        return [("softmax_label", (BATCH,))]


def _data(n=12, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 3, SIDE, SIDE)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.float32)
    return images, labels


def _fit(it, compute_dtype=None, hook=None, seed=0):
    net = tmodels.lenet()
    args, aux = random_params(net, seed, data=(BATCH, 3, SIDE, SIDE))
    model = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=1, optimizer="sgd",
                           learning_rate=1e-4, momentum=0.9,
                           arg_params=args, aux_params=aux,
                           compute_dtype=compute_dtype)
    model._step_hook = hook
    model.fit(it)
    return model


def test_uint8_batch_under_bf16_is_the_float_step_bitwise():
    images, labels = _data()
    seen = []
    u8 = _fit(_Batches(images, labels, np.uint8), torch.bfloat16,
              hook=lambda b, arrays: seen.append(arrays["data"].dtype))
    f32 = _fit(_Batches(images, labels, np.float32), torch.bfloat16)
    assert seen == [torch.uint8] * 3  # the feed hands the batch over as is
    for k, v in f32.arg_params.items():
        assert torch.equal(u8.arg_params[k], v), k
    assert not torch.equal(
        f32.arg_params["conv1_weight"],
        torch.from_numpy(random_params(tmodels.lenet(), 0, data=(
            BATCH, 3, SIDE, SIDE))[0]["conv1_weight"]))


def test_uint8_data_is_cast_in_the_graph():
    """The graph sees bf16 data and parameters; labels stay as given."""
    from mxnet_tpu_torch.model import _TrainState

    net = tmodels.lenet()
    args, _ = random_params(net, 0, data=(BATCH, 3, SIDE, SIDE))
    state = _TrainState(net, mt.optimizer.create("sgd"),
                        {k: torch.from_numpy(v) for k, v in args.items()},
                        {}, torch.device("cpu"),
                        compute_dtype=torch.bfloat16, data_names=["data"])
    seen, fn = {}, state.graph_fn

    def spy(values, aux_values, rng=None, mask=None):
        seen.update({k: v.dtype for k, v in values.items()})
        return fn(values, aux_values, rng, mask)

    state.graph_fn = spy
    images, labels = _data(n=BATCH)
    state.forward({"data": torch.from_numpy(images),
                   "softmax_label": torch.from_numpy(labels)})
    assert seen.pop("softmax_label") == torch.float32
    assert set(seen.values()) == {torch.bfloat16}


def test_threaded_feed_equals_synchronous_feed(monkeypatch):
    images, labels = _data(seed=1)
    got = {}
    for depth in ("2", "0"):
        monkeypatch.setenv("MXTPU_FEED_PREFETCH", depth)
        model = _fit(_Batches(images, labels, np.float32))
        got[depth] = model.arg_params
        assert len(model.feed_waits) == 3
    for k, v in got["2"].items():
        assert torch.equal(v, got["0"][k]), k


def test_each_step_reads_its_own_batch():
    images, labels = _data(seed=2)
    pairs = []
    _fit(_Batches(images, labels, np.float32), hook=lambda b, arrays: pairs.append(
        (b.data[0].clone(), arrays["data"].clone())))
    assert len(pairs) == 3
    for i, (host, dev) in enumerate(pairs):
        assert torch.equal(host, dev)
        assert torch.equal(host, torch.from_numpy(
            images[i * BATCH:(i + 1) * BATCH].astype(np.float32)))


def test_iterator_error_surfaces_and_the_thread_is_joined():
    images, labels = _data(seed=3)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="the iterator broke"):
        _fit(_Batches(images, labels, np.float32, fail_at=1))
    assert not [t for t in threading.enumerate()
                if t.name == "mxtorch-feed" and t.ident not in before]


def test_close_stops_a_feed_ahead_of_its_consumer():
    images, labels = _data(n=40, seed=4)
    feed = model_mod._DeviceFeed(_Batches(images, labels, np.float32),
                                 lambda b: {"data": b.data[0]},
                                 torch.device("cpu"), depth=2)
    first = next(iter(feed))
    assert first[1]["data"].shape == (BATCH, 3, SIDE, SIDE)
    feed.close()
    assert not feed._thread.is_alive()


def _digest(x, weights):
    """An exact integer digest of a uint8 batch: sum of pixel * weight in
    int64 (at most 2^40 here), the same on either device."""
    return int((x.to(torch.int64).flatten() * weights).sum())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return mt.gpu(0)


@pytest.mark.cuda
def test_feed_digest_per_step_on_card(cuda_device):
    """Every step reads on the card the batch the host made, through the
    feed thread's stream and event."""
    images, labels = _data(n=64, seed=5)
    weights = torch.from_numpy(np.random.RandomState(0).randint(
        1, 1000, BATCH * 3 * SIDE * SIDE).astype(np.int64))
    dev_w = weights.cuda()
    seen = []

    def hook(batch, arrays):
        seen.append((_digest(batch.data[0], weights),
                     _digest(arrays["data"], dev_w)))

    net = tmodels.lenet()
    args, aux = random_params(net, 0, data=(BATCH, 3, SIDE, SIDE))
    model = mt.FeedForward(net, ctx=cuda_device, num_epoch=1,
                           learning_rate=1e-4, arg_params=args,
                           aux_params=aux, compute_dtype=torch.bfloat16)
    model._step_hook = hook
    model.fit(_Batches(images, labels, np.uint8))
    assert len(seen) == 16 and all(h == d for h, d in seen)
